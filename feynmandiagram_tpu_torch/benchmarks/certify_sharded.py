"""Certify the graph-sharded evaluator at BASELINE-config-5 scale.

Port of ``benchmarks/certify_sharded.py``.  Order-N vertex-4 through the
full production path (Parquet build -> optimize(level=1) -> fused lowering
with single-assignment slots under the schedule that suits the mesh best
-> memory-partitioned sharded evaluation on an n-rank graph axis) on
``device``: the sharded roots must equal the unsharded evaluator's on the
same lowering, and the planner's memory and halo footprint is printed as
one JSON line.  The mesh is local: all its ranks run in this process on the
one device, so the times are of that device, not of a multi-device mesh.
On CUDA both evaluators run the same kernel on the same rows, and the
roots agree bit for bit; on the CPU the plain sums may round in another
order, within 1e-10 of each root's scale (float64).

Usage: python -m feynmandiagram_tpu_torch.benchmarks.certify_sharded
           [--order 5] [--n-graph 8] [--batch 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

CPU_RTOL = 1e-10


def certify(order: int = 5, n_graph: int = 8, batch: int = 4, device=None, *,
            roots=None, lowered=None, live_slots: Optional[int] = None) -> dict:
    """Run the certification and return the JSON line's fields.  ``roots``:
    the order's Gamma4 roots, generated and optimized already (then
    ``t_generate_s`` and ``t_optimize_s`` are 0).  ``lowered``: the sharded
    lowering itself, made already for ``n_graph`` ranks as
    ``lower_sharded_best`` makes it (loaded from an artifact, say), with
    ``live_slots``, the slots of the order's single-device fused lowering;
    then nothing is generated or lowered, and the schedule is not known.
    Raises ``RuntimeError`` where the sharded roots leave the unsharded
    ones."""
    from ..backends.compile import leafmap_of
    from ..ops import lower, make_evaluator
    from ..ops.dtypes import default_device
    from ..parallel import Mesh, lower_sharded_best, make_graph_sharded_evaluator

    device = torch.device(device) if device is not None else default_device()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_gen = t_opt = t_low = 0.0
    if lowered is not None:
        if roots is not None or live_slots is None:
            raise ValueError("a lowering made already takes live_slots and no roots")
        sched = None
    elif roots is None:
        from ..computational_graph import optimize_inplace
        from ..frontends import ChargeCharge, Instant, NoHartree
        from ..frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4
        t0 = time.perf_counter()
        para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True, filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        optimize_inplace(roots, level=1)
        t_opt = time.perf_counter() - t0
    if lowered is None:
        lm = leafmap_of(roots)
        t0 = time.perf_counter()
        lowered, sched = lower_sharded_best(roots, lm, n_graph)
        live_slots = lower(roots, lm, sum_mode="fused", cse=True, reuse_slots=True).num_slots
        t_low = time.perf_counter() - t0

    nl = lowered.num_leaves - len(lowered.const_slots)
    vals = np.random.default_rng(3).uniform(0.5, 1.5, (nl, batch))
    t0 = time.perf_counter()
    single = make_evaluator(lowered, device=device)(vals)
    sync()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = make_graph_sharded_evaluator(lowered, Mesh([("graph", n_graph)], device=device))
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    multi = sharded(vals)
    sync()
    t_shard = time.perf_counter() - t0
    bitwise = torch.equal(multi, single)
    scale = single.abs().amax(dim=1).clamp_min(torch.finfo(single.dtype).tiny)
    rel = ((multi - single).abs().amax(dim=1) / scale).max().item()
    if not (bitwise if device.type == "cuda" else rel <= CPU_RTOL):
        raise RuntimeError(f"sharded roots differ from the unsharded evaluator's: max "
                           f"per-root |diff|/scale {rel:.3e} on {device}")

    st = sharded.stats
    return {
        "order": order, "n_graph": n_graph, "batch": batch, "device": str(device),
        "dtype": str(single.dtype).split(".")[1], "schedule": sched,
        "full_slots": int(st.full_slots),
        "live_slots_single_device": int(live_slots),
        "local_slots_per_rank": int(st.local_slots),
        "local_vs_live_over_n": round(st.local_slots / (live_slots / n_graph), 3),
        "num_edges": int(lowered.num_edges),
        "num_levels": len(lowered.levels),
        "halo_rows_total": int(sum(st.halo_rows_per_level)),
        "halo_bytes_per_sample_f32": int(st.halo_bytes_per_sample()),
        "halo_pad_overhead": round(st.halo_pad_overhead, 3),
        "early_share": round(st.early_share, 3),
        "interleaved": bool(st.interleaved),
        "equal_to_single_device": "bit for bit" if bitwise else f"max rel {rel:.3e}",
        "t_generate_s": round(t_gen, 1), "t_optimize_s": round(t_opt, 1),
        "t_lower_s": round(t_low, 1), "t_plan_s": round(t_plan, 1),
        "t_eval_single_s": round(t_single, 3), "t_eval_sharded_s": round(t_shard, 3),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--order", type=int, default=5)
    parser.add_argument("--n-graph", type=int, default=8)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    print(json.dumps(certify(args.order, args.n_graph, args.batch, args.device)))


if __name__ == "__main__":
    main()
