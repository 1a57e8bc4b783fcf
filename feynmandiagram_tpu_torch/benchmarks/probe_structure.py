"""Probe: the structure of a Gamma4 lowering and the split of a pass's time.

Port of ``benchmarks/probe_structure.py``.  ``structure(lowered)`` returns
what the reference prints: per level the plans and their nodes and edges,
the histogram of each value's consumers (fan-out, capped at 10), the
histogram of each edge's distance in levels from the level that wrote its
source (leaves are level 0; capped at 8), the most values live at once
across the levels, and the product nodes with one consumer (fusable into
their sum).  An edge is a term of nonzero factor; a fused bucket's term
consumes each of its ``n_op`` operands, and a slot that the lowering
reuses holds one value after another, so the reference's statistics of a
bucketed lowering carry over to fused ones.  ``phase_ms`` times the leaf
phase, the graph phase and the whole pass on the card with CUDA events
after a warm-up, and the graph phase's edges per second.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.probe_structure [--order 4]
           [--device cpu]
The script lowers bucketed, as the reference does, and times at batch 4096.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

BETA, KF, LAM = 0.5, 1.919, 1.0
BATCH = 4096
FANOUT_CAP, DISTANCE_CAP = 10, 8


def _plans(lvl):
    """Each plan of a level as (kind, its first row, its rows, the slots its
    nonzero terms read, flat)."""
    out = []
    if lvl.sums is not None:
        s = lvl.sums
        out.append(("sum", s.start, s.count,
                    np.asarray(s.edge_src)[np.asarray(s.edge_factor) != 0]))
    for b in lvl.sum_buckets:
        out.append(("sum", b.start, b.count, np.asarray(b.idx)[np.asarray(b.fac) != 0]))
    for b in lvl.fused:
        out.append(("fused", b.start, b.count,
                    np.asarray(b.idx)[:, np.asarray(b.fac) != 0].ravel()))
    for p in lvl.prods:
        out.append(("prod", p.start, p.count, np.asarray(p.idx).ravel()))
    for pw in lvl.pows:
        out.append(("pow", pw.start, pw.count, np.asarray(pw.src).ravel()))
    return out


def structure(low) -> dict:
    """The reference's structural statistics of the lowering ``low``.

    They are taken over values, not slots: a slot that the lowering reuses
    holds one value after another, each with its own level and consumers.
    Without slot reuse (the bucketed lowering) a slot holds one value, and
    every statistic is the reference's, which reads slots."""
    levels = [_plans(lvl) for lvl in low.levels]
    per_level = []
    for lvl in low.levels:
        per_level.append({
            "sum_buckets": len(lvl.sum_buckets),
            "sum_nodes": sum(b.count for b in lvl.sum_buckets),
            "sum_edges": sum(int((np.asarray(b.fac) != 0).sum()) for b in lvl.sum_buckets),
            "fused": len(lvl.fused),
            "fused_nodes": sum(b.count for b in lvl.fused),
            "fused_edges": sum(int((np.asarray(b.fac) != 0).sum()) for b in lvl.fused),
            "prods": len(lvl.prods), "prod_nodes": sum(p.count for p in lvl.prods),
            "pows": len(lvl.pows), "pow_nodes": sum(p.count for p in lvl.pows)})
    # values 0 .. num_slots - 1 are what the slots hold before level 1 (the
    # leaves and constants among them), then one value a written row
    n_values = low.num_slots + sum(c for plans in levels for _, _, c, _ in plans)
    born = np.zeros(n_values, np.int64)       # the level that wrote the value
    uses = np.zeros(n_values, np.int64)       # its consumers
    last = np.zeros(n_values, np.int64)       # the last level that reads it
    is_prod = np.zeros(n_values, bool)
    value_of = np.arange(low.num_slots)
    written = np.zeros(low.num_slots, bool)
    deltas, top = [], low.num_slots
    for i, plans in enumerate(levels, start=1):
        for _, _, _, read in plans:     # no plan reads a row that its level writes
            vid = value_of[read]
            np.add.at(uses, vid, 1)
            np.maximum.at(last, vid, i)
            deltas.append(i - born[vid])
        for kind, start, count, _ in plans:
            value_of[start:start + count] = np.arange(top, top + count)
            born[top:top + count], is_prod[top:top + count] = i, kind == "prod"
            written[start:start + count] = True
            top += count
    # a slot's first value is counted where it is a leaf's or a constant's,
    # or the slot is never written; else the slot holds the written values
    counted = np.ones(n_values, bool)
    counted[np.flatnonzero(written[low.num_leaves:]) + low.num_leaves] = False
    deltas = np.concatenate(deltas) if deltas else np.zeros(0, np.int64)
    max_live = max((int(((born <= i) & (last >= i)).sum()) for i in range(1, len(levels) + 1)),
                   default=0)
    return {"slots": low.num_slots, "leaves": low.num_leaves, "levels": len(low.levels),
            "edges": low.num_edges, "roots": len(low.root_slots), "per_level": per_level,
            "device_ops": sum(lv["sum_buckets"] + lv["fused"] + lv["prods"] + lv["pows"]
                              for lv in per_level),
            "fanout_hist": np.bincount(np.minimum(uses[counted], FANOUT_CAP)).tolist(),
            "distance_hist": np.bincount(np.minimum(deltas, DISTANCE_CAP)).tolist(),
            "max_live_values": max_live, "prod_nodes": int(is_prod.sum()),
            "fanout1_prods": int((uses[is_prod] == 1).sum())}


def phase_ms(leaf_fn, graph_fn, full_fn, vk, vt) -> dict:
    """Device-side ms a call of the leaf phase, the graph phase and the
    whole pass (``benchmarks.events_ms``)."""
    from . import events_ms
    return {"leaf_ms": events_ms(leaf_fn, vk, vt),
            "graph_ms": events_ms(graph_fn, leaf_fn(vk, vt)),
            "full_ms": events_ms(full_fn, vk, vt)}


def report(st: dict) -> str:
    """The reference's printout of ``structure``'s result."""
    lines = [f"slots={st['slots']} leaves={st['leaves']} levels={st['levels']} "
             f"edges={st['edges']} roots={st['roots']}",
             f"{'lev':>3} {'sumbk':>6} {'sumnodes':>8} {'sumedges':>8} {'fused':>6} "
             f"{'fbnodes':>8} {'fbedges':>8} {'prods':>6} {'prodnodes':>9} {'pows':>5} "
             f"{'pownodes':>8}"]
    for i, lv in enumerate(st["per_level"]):
        lines.append(f"{i:3d} {lv['sum_buckets']:6d} {lv['sum_nodes']:8d} {lv['sum_edges']:8d} "
                     f"{lv['fused']:6d} {lv['fused_nodes']:8d} {lv['fused_edges']:8d} "
                     f"{lv['prods']:6d} {lv['prod_nodes']:9d} {lv['pows']:5d} "
                     f"{lv['pow_nodes']:8d}")
    lines += [f"total device ops (buckets+prods+pows): {st['device_ops']}",
              f"fan-out histogram (capped at {FANOUT_CAP}): {st['fanout_hist']}",
              f"edge src-level distance histogram (1=prev level, capped {DISTANCE_CAP}): "
              f"{st['distance_hist']}",
              f"max live values across levels: {st['max_live_values']} (of {st['slots']})",
              f"prod nodes: {st['prod_nodes']}, fan-out-1 prods: {st['fanout1_prods']}"]
    return "\n".join(lines)


def main(argv=None) -> None:
    from ..backends.compile import compile_evaluator
    from ..ops.dtypes import default_device, default_dtype
    from . import card_name
    from .gamma4_orders import vertex4_roots

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--order", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' skips the timing)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    t0 = time.perf_counter()
    roots, para = vertex4_roots(args.order)
    print(f"generate+optimize: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                 lam=LAM, device=device, dtype=default_dtype(device),
                                 sum_mode="bucketed")
    print(f"lower+compile: {time.perf_counter() - t0:.1f}s\n")
    print(report(structure(compiled.lowered)))
    if device.type != "cuda":
        return
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    vk = torch.randn((3, para.totalLoopNum, BATCH), generator=gen, device=device)
    vt = torch.rand((para.totalTauNum, BATCH), generator=gen, device=device) * BETA
    t = phase_ms(compiled.leaf_fn, compiled.graph_fn, compiled.fn, vk, vt)
    print(f"\nbatch={BATCH}: leaf={t['leaf_ms']:.3f}ms graph={t['graph_ms']:.3f}ms "
          f"full={t['full_ms']:.3f}ms -> {BATCH / t['full_ms'] * 1e3:.0f} samples/s "
          f"[{card_name()}]")
    print(f"graph-phase edges/s: {compiled.lowered.num_edges * BATCH / t['graph_ms'] / 1e6:.1f} G")


if __name__ == "__main__":
    main()
