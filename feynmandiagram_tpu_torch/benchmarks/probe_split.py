"""Probe: the leaf phase against the graph phase, and CSE on and off.

Port of ``benchmarks/probe_split.py``.  Lowers the order-N Gamma4 graph
bucketed with common-subexpression elimination off and on (slots, leaves,
edges, levels each), then times the leaf phase and the graph phase of the
CSE lowering at batch 4096 on the card (CUDA events around 30 calls after
a warm-up) and the graph phase's traffic over its time, counted as the
reference counts it: every edge's read and every computed slot's write, in
float32.  The sampled ``varT`` has ``totalTauNum`` rows, one a time
variable; the reference drew ``totalLoopNum`` rows, which is as many or
more for Gamma4, so its extra rows went unread.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.probe_split [--order 4]
           [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

BETA, KF, LAM = 0.5, 1.919, 1.0
BATCH, ITERS = 4096, 30


def cse_counts(roots) -> Dict[bool, dict]:
    """Slots, leaves, edges and levels of the bucketed lowering of
    ``roots`` with CSE off (False) and on (True)."""
    from ..backends.compile import leafmap_of
    from ..ops.lowering import lower

    leafmap = leafmap_of(roots)
    out = {}
    for cse in (False, True):
        low = lower(roots, leafmap, sum_mode="bucketed", cse=cse)
        out[cse] = {"slots": low.num_slots, "leaves": low.num_leaves,
                    "edges": low.num_edges, "levels": low.num_levels}
    return out


def graph_traffic_bytes(low, batch: int, itemsize: int = 4) -> int:
    """The reference's traffic count of the graph phase: an element read a
    edge and written a computed slot."""
    return (low.num_edges + low.num_slots - low.num_leaves) * batch * itemsize


def split_ms(compiled, para, batch: int, device) -> Dict[str, float]:
    """Device-side ms a call of the leaf phase and of the graph phase
    (``benchmarks.events_ms``, ITERS calls)."""
    from . import events_ms
    rng = np.random.default_rng(0)
    varK = torch.as_tensor(rng.standard_normal((3, para.totalLoopNum, batch)),
                           dtype=torch.float32, device=device)
    varT = torch.as_tensor(rng.random((para.totalTauNum, batch)) * BETA,
                           dtype=torch.float32, device=device)
    return {"leaf_ms": events_ms(compiled.leaf_fn, varK, varT, iters=ITERS),
            "graph_ms": events_ms(compiled.graph_fn, compiled.leaf_fn(varK, varT), iters=ITERS)}


def main(argv=None) -> None:
    from ..backends.compile import compile_evaluator
    from ..ops.dtypes import default_device
    from . import card_name
    from .gamma4_orders import vertex4_roots

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--order", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' skips the timing)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    roots, para = vertex4_roots(args.order)
    for cse, c in cse_counts(roots).items():
        print(f"cse={cse}: slots={c['slots']} leaves={c['leaves']} edges={c['edges']} "
              f"levels={c['levels']}")
    if device.type != "cuda":
        return
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                 lam=LAM, device=device, dtype=torch.float32,
                                 sum_mode="bucketed")
    t = split_ms(compiled, para, BATCH, device)
    tl, tg = t["leaf_ms"], t["graph_ms"]
    b = BATCH
    print(f"leaf phase : {tl:7.3f} ms  ({b / tl:.0f}k samples/s)")
    print(f"graph phase: {tg:7.3f} ms  ({b / tg:.0f}k samples/s)")
    print(f"combined   : {tl + tg:7.3f} ms  ({b / (tl + tg):.0f}k samples/s)")
    traffic = graph_traffic_bytes(compiled.lowered, b)
    print(f"graph-phase traffic ~{traffic / 1e9:.2f} GB -> {traffic / tg / 1e6:.0f} GB/s "
          f"[{card_name()}]")


if __name__ == "__main__":
    main()
