"""The float32 pass's error against float64, root by root, over several draws.

The check of ``chip_smoke.py`` holds one draw: each root's max|f32 - f64| /
max|f64| over a batch, against SLICE_TOL.  This script draws ``--draws``
batches from seeds 0, 1, ... (numpy, as the check does) and prints, for
each, the worst root and its error, each against the float64 pass on the
same draw, for:

- ``f32_pass``: the float32 pass, whose leaf phase computes in float64 and
  rounds each leaf once (``ops/leaf_eval.py``);
- ``f64_graph_on_f32_leaves``: a float64 graph phase on the same leaves,
  the part of that one rounding;
- ``f64_accumulation``: the float32 graph phase accumulating in float64 on
  the same leaves, the part of float32 storage alone;
- ``f32_arithmetic_leaves``: the float32 pass on leaves computed in float32
  arithmetic, as the JAX package computes them;

then, per field, the median and the largest error over the draws and how
many draws miss chip_smoke's limit, SLICE_TOL.  The lowering comes from an
artifact (``benchmarks/gamma4_orders.py``).

Usage: python -m feynmandiagram_tpu_torch.benchmarks.slice_error ARTIFACT ORDER
           [--batch 512] [--draws 16] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

BETA, KF, LAM = 0.5, 1.919, 1.0
SLICE_TOL = 1e-5    # chip_smoke.py's limit on each root's max|f32 - f64| / max|f64|


def worst_root(got: torch.Tensor, ref: torch.Tensor):
    """(max over roots of max|got - ref| / max|ref|, that root)."""
    rel = (got.double() - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
    k = int(rel.argmax())
    return rel[k].item(), k


def draws(path: str, order: int, *, batch: int, n: int, device) -> list:
    """One dict a draw: the worst root of each field of the module's
    docstring, against the float64 pass on the same draw."""
    from ..backends.compile import load_artifact
    from ..ops.evaluator import make_evaluator
    from ..ops.leaf_eval import make_leaf_evaluator
    from .gamma4_orders import vertex4_para

    lowered, tables = load_artifact(path)
    para = vertex4_para(order)
    kw = dict(beta=BETA, kF=KF, lam=LAM, device=device)
    leaf32 = make_leaf_evaluator(tables, dtype=torch.float32, **kw)
    leaf64 = make_leaf_evaluator(tables, dtype=torch.float64, **kw)
    leaf32_arith = make_leaf_evaluator(tables, dtype=torch.float32,
                                       compute_dtype=torch.float32, **kw)
    graph32 = make_evaluator(lowered, device=device, dtype=torch.float32)
    graph32_acc64 = make_evaluator(lowered, device=device, dtype=torch.float32,
                                   acc_dtype=torch.float64)
    graph64_plain = make_evaluator(lowered, device=device, dtype=torch.float64, kernel=False)
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        vk = rng.standard_normal((3, para.totalLoopNum, batch))
        vt = rng.random((para.totalTauNum, batch)) * BETA
        ref = graph64_plain(leaf64(vk, vt))
        leaves = leaf32(vk, vt)
        out.append({"seed": seed,
                     "f32_pass": worst_root(graph32(leaves), ref),
                     "f64_graph_on_f32_leaves": worst_root(graph64_plain(leaves.double()), ref),
                     "f64_accumulation": worst_root(graph32_acc64(leaves), ref),
                     "f32_arithmetic_leaves": worst_root(graph32(leaf32_arith(vk, vt)), ref)})
    return out


def main(argv=None) -> None:
    from ..ops.dtypes import default_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("artifact")
    parser.add_argument("order", type=int)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--draws", type=int, default=16)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    rows = draws(args.artifact, args.order, batch=args.batch, n=args.draws, device=device)
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {}
    for key in rows[0]:
        if key != "seed":
            worst = [r[key][0] for r in rows]
            summary[key] = {"median": float(np.median(worst)), "max": max(worst),
                            "over_limit": sum(e > SLICE_TOL for e in worst)}
    print(json.dumps({"order": args.order, "batch": args.batch, "draws": len(rows),
                      "limit": SLICE_TOL, "device": str(device), **summary}))


if __name__ == "__main__":
    main()
