"""Scan of fused-bucket merging (``merge_threshold``) x batch on the card.

Port of ``benchmarks/scan_merge.py``.  The order-N Gamma4 graph is generated
and optimized once; for each threshold the roots are compiled fused
(``compile_evaluator(sum_mode='fused', merge_threshold=...)``) and each batch
is timed by ``mc.mc_samples_per_s``, the port's Monte-Carlo loop (sampling,
leaf phase, graph phase, batch sum; one warm-up run, the median of three).
The reference also timed host dispatch pass by pass under ``jit``; the
port's loop is eager, so that mode has no counterpart.  One JSON line per
configuration: threshold, batch, buckets, slots, edges, gathered elements a
sample (``padded_elements``) and samples/s, with the card's name.  The
default batches are the port's own (2048-16384); the reference's 1536 came
from the TPU's VMEM rule.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.scan_merge [--order 4]
           [--thresholds 0,2000,...] [--batches 2048,...] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Iterator, Sequence

import torch

BETA, KF, LAM = 0.5, 1.919, 1.0
THRESHOLDS = (0, 2000, 10000, 50000, 200000, 1000000000)
BATCHES = (2048, 4096, 8192, 16384)


def padded_elements(lowered) -> int:
    """Gathered operand elements a sample, padding reads included (the
    reference's count)."""
    tot = 0
    for lv in lowered.levels:
        for fb in lv.fused:
            tot += fb.n_op * fb.arity * fb.count
        for sb in lv.sum_buckets:
            tot += sb.arity * sb.count
        for p in lv.prods:
            tot += p.arity * p.count
        for pw in lv.pows:
            tot += pw.count
    return tot


def n_buckets(lowered) -> int:
    """Buckets of a fused lowering as the reference counts them: its fused
    buckets and its power plans."""
    return sum(len(lv.fused) + len(lv.pows) for lv in lowered.levels)


def scan(roots, para, thresholds: Sequence[int], batches: Sequence[int], *, device,
         iters: int = 100) -> Iterator[dict]:
    """One dict per (threshold, batch): the fused lowering's structure and
    the samples/s of ``mc.mc_samples_per_s`` at ``iters`` passes a run.
    Float32 on CUDA, float64 on the CPU."""
    from ..backends.compile import compile_evaluator
    from ..mc import mc_samples_per_s
    from ..ops.dtypes import default_dtype

    device = torch.device(device)
    dtype = default_dtype(device)
    for thr in thresholds:
        compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                     lam=LAM, device=device, dtype=dtype, sum_mode="fused",
                                     merge_threshold=thr)
        low = compiled.lowered
        for batch in batches:
            sps = mc_samples_per_s(compiled.fn, n_loop=para.totalLoopNum,
                                   num_tau=para.totalTauNum, batch=batch,
                                   n_roots=len(low.root_slots), device=device, dtype=dtype,
                                   iters=iters, beta=BETA)
            yield {"threshold": thr, "batch": batch, "buckets": n_buckets(low),
                   "num_slots": low.num_slots, "num_edges": low.num_edges,
                   "padded_elements": padded_elements(low), "samples_per_s": round(sps, 1)}


def main(argv=None) -> None:
    from ..ops.dtypes import default_device
    from . import card_name
    from .gamma4_orders import vertex4_roots

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--order", type=int, default=4)
    parser.add_argument("--thresholds", default=",".join(map(str, THRESHOLDS)))
    parser.add_argument("--batches", default=",".join(map(str, BATCHES)))
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    platform = card_name() if device.type == "cuda" else "cpu"
    roots, para = vertex4_roots(args.order)
    for row in scan(roots, para, [int(x) for x in args.thresholds.split(",")],
                    [int(x) for x in args.batches.split(",")], device=device):
        print(json.dumps({"order": args.order, **row, "platform": platform}), flush=True)


if __name__ == "__main__":
    main()
