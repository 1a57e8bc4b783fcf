"""Batched evaluator for lowered graphs, in PyTorch.

Port of ``feynmandiagram_tpu/ops/evaluator.py`` in its flat layout: the
weight buffer ``w`` is ``[num_slots, batch]``, slot-major, so a gather reads
whole rows.  Levels run in order; within a level the plans run in the
reference's order: the CSR sum, the sum buckets, the fused buckets, the
products, the powers.

- ``SumPlan``: gather, scale, ``index_add_`` into the level's rows
- ``SumBucket`` / ``FusedBucket``: all of a level's buckets in one launch
  of the gather-reduce kernel (``level_gather_reduce``)
- ``ProdPlan`` / ``PowerPlan``: plain PyTorch (XLA ops in the reference)

Each level runs in a profiler scope ``gL{NN}``, and within it the CSR sum
in ``csr``, the level's one bucket launch in ``fb{n}`` (``sb{n}`` when it
holds only sum buckets; ``n`` buckets), each product in ``prod{arity}``
and each power in ``pow{n}``: the JAX package's ``jax.named_scope`` names,
read by ``benchmarks/profile_pass.py``.  A scope is entered only while a
profiler runs (``utils.profiling.scope``).

JAX's evaluator was functional (``dynamic_update_slice`` on an immutable
buffer); this one writes each plan's rows of ``w`` in place.  That is safe
because no plan of a level reads a row that a plan of that level writes:
``lower()`` frees a slot for reuse only when its last read lies in an
earlier level, and a node reads only lower levels.  It is also why a
level's buckets may run at once.  ``make_evaluator`` checks it once, with
the bounds of every index (the reference relies on ``promise_in_bounds``;
the kernel has no clamp).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .lowering import LoweredGraph, lower
from .dtypes import default_device, default_dtype
from ..utils.profiling import scope
from .kernels import (LevelTables, cuda_type_codes, level_gather_reduce,
                      level_gather_reduce_plain, pack_level)


@dataclass
class _Level:
    csr: Optional[tuple]     # (start, count, src, fac, seg)
    tables: Optional[LevelTables]   # sum buckets, then fused buckets, packed
    prods: List[tuple]       # (start, count, idx [arity, count], factor [count], scope)
    pows: List[tuple]        # (n, start, count, src, factor, scope)
    scope: str               # the level's profiler scope, and its bucket launch's
    bucket_scope: str


def level_buckets(lvl) -> list:
    """The buckets ``(idx [n_op, arity, count], fac, start)`` of a
    ``LevelPlan``: its sum buckets (``n_op`` 1), then its fused buckets."""
    return ([(np.asarray(sb.idx)[None], np.asarray(sb.fac), sb.start)
             for sb in lvl.sum_buckets]
            + [(np.asarray(fb.idx), np.asarray(fb.fac), fb.start) for fb in lvl.fused])


def check_lowered(lowered: LoweredGraph) -> None:
    """Raise if any index of ``lowered`` is out of bounds, or any plan of a
    level reads a row that a plan of the same level writes."""
    n = lowered.num_slots

    def in_bounds(what: str, a) -> None:
        a = np.asarray(a)
        if a.size and (a.min() < 0 or a.max() >= n):
            raise ValueError(f"{what}: index out of bounds for {n} slots")

    def rows(what: str, start: int, count: int) -> None:
        if start < 0 or start + count > n:
            raise ValueError(f"{what}: rows {start}..{start + count} outside {n} slots")

    in_bounds("root_slots", lowered.root_slots)
    in_bounds("const_slots", lowered.const_slots)
    for li, lvl in enumerate(lowered.levels):
        plans = []   # (what, start, count, indices read)
        if lvl.sums is not None:
            plans.append((f"level {li} sums", lvl.sums.start, lvl.sums.count,
                          lvl.sums.edge_src))
            seg = np.asarray(lvl.sums.edge_seg)
            if seg.size and (seg.min() < 0 or seg.max() >= lvl.sums.count):
                raise ValueError(f"level {li} sums: segment out of range")
        plans += [(f"level {li} sum bucket", b.start, b.count, b.idx) for b in lvl.sum_buckets]
        plans += [(f"level {li} fused bucket", b.start, b.count, b.idx) for b in lvl.fused]
        plans += [(f"level {li} prod", p.start, p.count, p.idx) for p in lvl.prods]
        plans += [(f"level {li} pow", pw.start, pw.count, pw.src) for pw in lvl.pows]
        written = np.zeros(n, bool)
        for what, start, count, read in plans:
            rows(what, start, count)
            in_bounds(what, read)
            written[start:start + count] = True
        for what, start, _, read in plans:
            read = np.asarray(read)
            if read.size and written[read].any():
                raise ValueError(f"{what} at row {start} reads row "
                                 f"{int(read[written[read]].flat[0])}, which level {li} "
                                 f"writes")


def _upload(lowered: LoweredGraph, device, fac_dtype) -> List[_Level]:
    def i64(a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)

    def f(a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(fac_dtype)

    levels = []
    for li, lvl in enumerate(lowered.levels):
        csr = None
        if lvl.sums is not None:
            s = lvl.sums
            csr = (s.start, s.count, i64(s.edge_src), f(s.edge_factor), i64(s.edge_seg))
        buckets = level_buckets(lvl)
        tables = pack_level(buckets, device, fac_dtype) if buckets else None
        prods = [(p.start, p.count, i64(p.idx), f(p.factor), f"prod{p.arity}")
                 for p in lvl.prods]
        pows = [(pw.n, pw.start, pw.count, i64(pw.src), f(pw.factor), f"pow{pw.n}")
                for pw in lvl.pows]
        levels.append(_Level(csr, tables, prods, pows, f"gL{li:02d}",
                             f"{'fb' if lvl.fused else 'sb'}{len(buckets)}"))
    return levels


def _eval_levels(levels: List[_Level], w: torch.Tensor, acc_dtype=None,
                 compensated: bool = False, chunk_rows: Optional[int] = None,
                 kernel: bool = True) -> torch.Tensor:
    """Run all levels on ``w`` in place and return it.

    ``acc_dtype`` widens arithmetic: gathered rows are upcast, the plan
    computes in ``acc_dtype`` and stores back at ``w.dtype``.
    ``compensated`` switches every bucket reduction to Kahan summation.
    ``kernel=False`` runs the buckets through the plain version on any
    device (the reference the kernel is checked against)."""
    a = acc_dtype or w.dtype
    level_op = level_gather_reduce if kernel else level_gather_reduce_plain
    for lvl in levels:
        with scope(lvl.scope):
            if lvl.csr is not None:
                with scope("csr"):
                    start, count, src, fac, seg = lvl.csr
                    contrib = w[src].to(a) * fac[:, None]
                    block = torch.zeros((count, w.shape[1]), dtype=a, device=w.device)
                    block.index_add_(0, seg, contrib)
                    w[start:start + count] = block.to(w.dtype)
            if lvl.tables is not None:
                with scope(lvl.bucket_scope):
                    level_op(w, lvl.tables, compensated=compensated, acc_dtype=acc_dtype,
                             chunk_rows=chunk_rows)
            for start, count, idx, factor, name in lvl.prods:
                with scope(name):
                    block = w[idx[0]].to(a)
                    for k in range(1, idx.shape[0]):
                        block = block * w[idx[k]].to(a)
                    w[start:start + count] = (block * factor[:, None]).to(w.dtype)
            for n, start, count, src, factor, name in lvl.pows:
                with scope(name):
                    block = torch.pow(w[src].to(a), n) * factor[:, None]
                    w[start:start + count] = block.to(w.dtype)
    return w


def make_evaluator(lowered: LoweredGraph, *, device=None, dtype=None,
                   return_all: bool = False, acc_dtype=None,
                   compensated: bool = False, chunk_rows: Optional[int] = None,
                   kernel: bool = True):
    """Build ``f(leaf_values[num_leaves, batch]) -> roots[num_roots, batch]``.

    ``leaf_values`` covers the non-constant leaf slots (0..nl-1); constant
    slots are filled internally.  With ``return_all`` the whole weight
    buffer is returned.  Index and factor tables are checked and uploaded
    to ``device`` once, here.  ``chunk_rows`` only bounds the temporaries of
    the plain bucket version; ``kernel=False`` runs the buckets through that
    version on any device.  ``dtype`` and ``acc_dtype`` are the storage and
    accumulation types (``torch.bfloat16`` with ``torch.float32`` is the JAX
    package's half-width buffer); the CUDA kernel takes the pairs of
    ``kernels.CUDA_DTYPE_PAIRS`` and raises here on any other.
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    a = acc_dtype or dtype
    if kernel and device.type == "cuda":
        cuda_type_codes(dtype, a, acc_dtype)
    check_lowered(lowered)
    num_slots = lowered.num_slots
    n_const = len(lowered.const_slots)
    nl_input = lowered.num_leaves - n_const
    const_values = torch.as_tensor(np.asarray(lowered.const_values), device=device).to(dtype)
    root_slots = torch.as_tensor(np.asarray(lowered.root_slots, np.int64), device=device)
    levels = _upload(lowered, device, a)

    def evaluate(leaf_values) -> torch.Tensor:
        leaf_values = torch.as_tensor(leaf_values, device=device).to(dtype)
        if leaf_values.dim() == 1:
            leaf_values = leaf_values[:, None]
        batch = leaf_values.shape[1]
        # zero-initialised: padding terms carry fac = 0, and 0 * NaN from
        # uninitialised rows would poison their sums
        w = torch.zeros((num_slots, batch), dtype=dtype, device=device)
        w[:len(leaf_values)] = leaf_values
        if n_const:
            w[nl_input:nl_input + n_const] = const_values[:, None]
        _eval_levels(levels, w, acc_dtype, compensated, chunk_rows, kernel)
        if return_all:
            return w
        out = w[root_slots]
        return out.to(acc_dtype) if acc_dtype is not None else out

    return evaluate


def evaluate_graphs(roots: Sequence, leaf_values,
                    leafmap: Optional[Dict[int, int]] = None, *,
                    device=None, dtype=None) -> np.ndarray:
    """One-shot convenience: lower + evaluate ``roots`` on ``leaf_values``.

    ``leaf_values``: [num_leaves] or [num_leaves, batch], indexed by
    ``leafmap`` (or by lowering's first-visit leaf order when absent).
    """
    lowered = lower(roots, leafmap)
    f = make_evaluator(lowered, device=device, dtype=dtype)
    return f(leaf_values).cpu().numpy()
