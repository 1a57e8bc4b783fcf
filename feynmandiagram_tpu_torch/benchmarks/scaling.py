"""Scaling harness: the sample axis and the graph axis on a local mesh.

Port of ``benchmarks/scaling.py`` on the port's ``parallel`` layer.  For
rank counts 1..N of a mesh local to this process, on its one device:

- sample axis (data parallel): samples/s of the fused order-``ORDER`` Gamma4
  pass at a fixed total batch (``shard_compiled``);
- graph axis (memory-partitioned): edges/s through the graph-sharded
  evaluator (``make_graph_sharded_evaluator``) on the lowering with one
  slot a node, its roots against the unsharded evaluator's on the same
  leaf values (bit for bit on CUDA, where both run the same kernel on the
  same rows; within 1e-10 of each root's scale on the CPU, whose plain
  sums may round in another order), the planner's exact per-level halo
  rows, and an analytic link model: the halo bytes a pass over NVLINK_GBPS.

All the ranks of a local mesh run one after the other on the one device,
as the reference's virtual CPU mesh time-shares the host's cores.  So the
script shows the mechanics (the collectives run, the numbers agree) and
the halo model; it does not measure scaling on hardware.  The link model
is the projection for ranks on separate cards.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.scaling [--ranks 8] [--order 3]
           [--batch 1024] [--iters 10] [--device cpu]
Prints one JSON line a measurement, then a markdown table.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Sequence

import numpy as np
import torch

BETA, KF, LAM = 0.5, 1.919, 1.0
# NVIDIA's H100 SXM data sheet gives NVLink 4 at 900 GB/s per card, both
# directions together; an all-gather receives at most half of it
NVLINK_GBPS = 450.0
CPU_RTOL = 1e-10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_counts(n: int) -> List[int]:
    """The powers of two up to ``n``, as the reference's 1, 2, 4, 8, 16."""
    return [k for k in (1, 2, 4, 8, 16) if k <= n]


def sample_axis_points(compiled, para, counts: Sequence[int], batch_total: int,
                       iters: int, device) -> List[dict]:
    """samples/s at a fixed total batch, split over a local sample axis of
    each rank count."""
    from ..parallel import make_sample_mesh, shard_compiled

    device = torch.device(device)
    rng = np.random.default_rng(0)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    varK = torch.as_tensor(rng.standard_normal((3, para.totalLoopNum, batch_total)),
                           dtype=dtype, device=device)
    varT = torch.as_tensor(rng.random((para.totalTauNum, batch_total)) * BETA, dtype=dtype,
                           device=device)
    points = []
    for n in counts:
        fn = shard_compiled(compiled, make_sample_mesh(n, device=device))
        fn(varK, varT)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(varK, varT)
        _sync(device)
        dt = time.perf_counter() - t0
        points.append({"axis": "sample", "devices": n,
                       "samples_per_s": round(batch_total * iters / dt, 1)})
    return points


def graph_axis_points(roots, counts: Sequence[int], batch: int, iters: int,
                      device) -> List[dict]:
    """edges/s through the graph-sharded evaluator on a local graph axis of
    each rank count, its roots against the unsharded evaluator's, and the
    planner's halo traffic.  Raises ``RuntimeError`` where the roots
    differ."""
    from ..backends.compile import leafmap_of
    from ..ops import lower, make_evaluator
    from ..parallel import Mesh, make_graph_sharded_evaluator

    device = torch.device(device)
    lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True, reuse_slots=False)
    nl = lowered.num_leaves - len(lowered.const_slots)
    vals = np.random.default_rng(1).uniform(0.5, 1.5, (nl, batch))
    single = make_evaluator(lowered, device=device)(vals)
    scale = single.abs().amax(dim=1).clamp_min(torch.finfo(single.dtype).tiny)
    points = []
    for n in counts:
        fn = make_graph_sharded_evaluator(lowered, Mesh([("graph", n)], device=device))
        out = fn(vals)
        _sync(device)
        rel = ((out - single).abs().amax(dim=1) / scale).max().item()
        same = torch.equal(out, single)
        if not (same if device.type == "cuda" else rel <= CPU_RTOL):
            raise RuntimeError(f"graph axis, {n} ranks: the roots differ from the unsharded "
                               f"evaluator's by {rel:.3e} of a root's scale on {device}")
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(vals)
        _sync(device)
        dt = time.perf_counter() - t0
        s = fn.stats
        halo_bytes = s.halo_bytes_per_sample(4) * batch
        points.append({
            "axis": "graph", "devices": n,
            "edges_per_s": round(lowered.num_edges * batch * iters / dt, 0),
            "local_slots": s.local_slots, "full_slots": s.full_slots,
            "mem_ratio": round(s.local_slots / s.full_slots, 4),
            "halo_rows_per_level": list(map(int, s.halo_rows_per_level)),
            "halo_MB_per_pass": round(halo_bytes / 1e6, 3),
            "nvlink_model_ms_per_pass": round(halo_bytes / (NVLINK_GBPS * 1e9) * 1e3, 4),
            "equal_to_unsharded": "bit for bit" if same else f"max rel {rel:.3e}"})
    return points


def table(points: Sequence[dict]) -> str:
    """The reference's markdown table of rates, speedups and efficiencies."""
    base_s = next(p for p in points if p["axis"] == "sample")["samples_per_s"]
    base_g = next(p for p in points if p["axis"] == "graph")["edges_per_s"]
    lines = ["| axis | devices | rate | speedup | efficiency |", "|---|---|---|---|---|"]
    for p in points:
        if p["axis"] == "sample":
            sp = p["samples_per_s"] / base_s
            lines.append(f"| sample | {p['devices']} | {p['samples_per_s']:.0f} samp/s "
                         f"| {sp:.2f}x | {sp / p['devices']:.0%} |")
        else:
            sp = p["edges_per_s"] / base_g
            lines.append(f"| graph | {p['devices']} | {p['edges_per_s']:.2e} edge/s "
                         f"| {sp:.2f}x | {sp / p['devices']:.0%} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    from ..backends.compile import compile_evaluator
    from ..ops.dtypes import default_device, default_dtype
    from . import card_name
    from .gamma4_orders import vertex4_roots

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--order", type=int, default=3)
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    counts = rank_counts(args.ranks)
    platform = card_name() if device.type == "cuda" else "cpu"
    print(f"# device={platform} local ranks={counts} order={args.order}")
    roots, para = vertex4_roots(args.order)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                 lam=LAM, device=device, dtype=default_dtype(device))
    points = sample_axis_points(compiled, para, counts, args.batch, args.iters, device)
    points += graph_axis_points(roots, counts, max(args.batch // 4, 64), args.iters, device)
    for p in points:
        print(json.dumps(p))
    print("\n" + table(points))


if __name__ == "__main__":
    main()
