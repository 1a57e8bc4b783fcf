"""Config 4: the order-4 self-energy's renormalized counterterm series.

Port of ``benchmarks/bench_config4.py``.  Order-4 Σ (innerLoopNum 4,
NoHartree, instant charge-charge) -> ``taylorAD([2, 2])`` counterterm
towers (9 order tuples, 36 roots, all coefficient graphs through ONE shared
IR) -> the Monte-Carlo pass on the card (sampling, leaf phase with the G
and V derivative orders, graph phase through the bucket kernel), measured
by ``mc.mc_samples_per_s`` as the Γ4 main path is.  Reference anchor for
the workload: FeynmanDiagram.jl/src/utility.jl:48-93 (taylorAD) driving
the MC pipeline of FeynmanDiagram.jl/example/benchmark.jl:39-87.

The batch is 8192 unless given: the JAX package's ``recommended_batch``
is a rule for the TPU's VMEM and has no counterpart in the port.  8192 is
the batch at which the port's order-4 Γ4 pass was last timed on the H100;
it stays until a batch sweep on the card gives the H100's own rule.  The
dtype follows the device (``default_dtype``): float32 on the card,
float64 on the CPU.

Prints one JSON line, with the reference's keys; ``platform`` is the
card's name and power limit as ``nvidia-smi`` gives them, and
``host_gen_ad_s`` also counts the lowering and the tables' upload
(``build_config4``), which the reference's figure leaves out.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.bench_config4
           [batch] [iters] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Tuple

import numpy as np
import torch

BETA, KF, LAM = 0.5, 1.919, 1.0
BATCH, ITERS = 8192, 200


def config4_roots(order: int = 4):
    """The order-``order`` Σ diagrams, optimized, Taylor-expanded in the G
    and V counterterm orders up to 2 each and optimized again:
    ``(roots, para, root_orders)``, the roots sorted by order tuple and,
    within one, in the diagrams' order, and each root's order tuple."""
    from ..computational_graph import optimize_inplace
    from ..frontends import ChargeCharge, Instant, NoHartree
    from ..frontends.diagram_id import BareGreenId, BareInteractionId
    from ..frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
    from ..utility import taylorAD

    para = DiagPara(type=SigmaDiag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    roots = [row["diagram"] for row in sigma(para, extK, False)]
    optimize_inplace(roots, level=1)
    dict_g = taylorAD(roots, [2, 2],
                      [lambda p: isinstance(p, BareGreenId),
                       lambda p: isinstance(p, BareInteractionId)])
    all_roots = [g for o in sorted(dict_g) for g in dict_g[o]]
    root_orders: List[Tuple[int, ...]] = [o for o in sorted(dict_g) for _ in dict_g[o]]
    optimize_inplace(all_roots, level=1)
    return all_roots, para, root_orders


def build_config4(order: int = 4, *, device=None, dtype=None, sum_mode: str = "fused"):
    """Generate config 4 (``config4_roots``) and compile it on ``device``
    (default: the CUDA card; ``RuntimeError`` without one):
    ``(compiled, para, root_orders)``, the ``CompiledEvaluator``, the
    diagram parameters (``totalLoopNum``, ``totalTauNum``) and each root's
    (G order, V order)."""
    from ..backends.compile import compile_evaluator

    roots, para, root_orders = config4_roots(order)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                                 kF=KF, lam=LAM, device=device, dtype=dtype,
                                 sum_mode=sum_mode)
    return compiled, para, root_orders


def main(argv=None) -> dict:
    from . import card_name
    from ..mc import mc_samples_per_s
    from ..ops.dtypes import default_device, default_dtype

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=BATCH)
    parser.add_argument("iters", nargs="?", type=int, default=ITERS)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device is not None else default_device()
    dtype = default_dtype(device)

    t0 = time.perf_counter()
    compiled, para, _ = build_config4(device=device, dtype=dtype)
    t_host = time.perf_counter() - t0
    low = compiled.lowered
    sps = mc_samples_per_s(compiled.fn, n_loop=para.totalLoopNum,
                           num_tau=para.totalTauNum, batch=args.batch,
                           n_roots=len(low.root_slots), device=device, dtype=dtype,
                           iters=args.iters, beta=BETA)
    result = {
        "metric": "mc_samples_per_s_config4_sigma_ct22",
        "value": round(sps, 1),
        "unit": "samples/s/chip",
        "extra": {
            "host_gen_ad_s": round(t_host, 2),
            "edges_per_s": round(low.num_edges * sps, 0),
            "batch": args.batch, "iters": args.iters,
            "recommended_batch": None,
            "num_roots": len(low.root_slots),
            "num_slots": low.num_slots, "num_edges": low.num_edges,
            "num_levels": low.num_levels,
            "platform": card_name() if device.type == "cuda" else "cpu",
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
