"""Batched evaluator for lowered graphs, in PyTorch.

Port of ``feynmandiagram_tpu/ops/evaluator.py`` in its flat layout: the
weight buffer ``w`` is ``[num_slots, batch]``, slot-major, so a gather reads
whole rows.  Levels run in order; within a level the CSR sum, then the
one launch of the sum buckets, the fused buckets, the products and the
powers (the reference's order), then any plain product or power.

- ``SumPlan``: gather, scale, ``index_add_`` into the level's rows
- ``SumBucket`` / ``FusedBucket``, and every ``ProdPlan`` of arity and
  ``PowerPlan`` of exponent ``1..MAX_N_OP``: all in one launch of the
  gather-reduce kernel a level (``kernels.pack_level``); a product of
  arity k is the bucket of one term and ``n_op = k``, a power of n the
  bucket of one term of its row repeated n times (``level_buckets``)
- a ``ProdPlan`` or ``PowerPlan`` outside that range (no configuration of
  this package has one): plain PyTorch, as XLA ops run it in the reference

The kernel multiplies a term as ``(w[i0] * fac) * w[i1] * ...``; the JAX
package computes a product ``(w[i0] * w[i1] * ...) * fac`` and a power
``integer_pow(w[i], n) * fac``.  The two differ in rounding only: a few
ulps of the accumulation type.

On CUDA with the kernel, a pass launches from a *launch plan*, built at the
first pass of each batch size and kept (``launch_plan``): at build time the
pass is cut into steps (``cut_runs``), the Python part of a level (its CSR
sum, before the level's launch, and its plain products and powers, after
it) a step of its own and each *run* of level launches between two such
parts one C call that issues them in order (``kernels.levels_gather_reduce``),
from a host table of their records, column groups and tables prepared for
that batch, with none of the per-launch checks, which the build and the plan
made once.  Within a run, each stretch of two or more consecutive levels
that are thin at that batch (``kernels.is_thin``: few bytes, short rows) is
one launch of the column-run kernel, whose blocks each carry a slice of the
batch's columns through every level of the stretch.  Each launch computes
what ``level_gather_reduce_plain`` computes, in the same order and
arithmetic; on the CPU, or with ``kernel=False``, every level runs through
that plain version (``_eval_levels``), the reference.

Each level runs in a profiler scope ``gL{NN}``, and within it the CSR sum
in ``csr``, the level's one launch in ``fb{n}`` (``sb{n}`` when it holds
only sum buckets; ``n`` buckets and plans), each plain product in
``prod{arity}`` and each plain power in ``pow{n}``: the JAX package's
``jax.named_scope`` names, read by ``benchmarks/profile_pass.py``.  A scope
is entered only while a profiler runs or a capture is open
(``utils.profiling.scope``).  A run's C call runs in the scope ``levels``,
and its launches join a capture's manifest under their levels' paths
(``gL05/fb8``), a column run under its stretch's (``gL04-gL298/run``).

JAX's evaluator was functional (``dynamic_update_slice`` on an immutable
buffer); this one writes each plan's rows of ``w`` in place.  That is safe
because no plan of a level reads a row that a plan of that level writes:
``lower()`` frees a slot for reuse only when its last read lies in an
earlier level, and a node reads only lower levels.  It is also why a
level's buckets may run at once.  ``make_evaluator`` checks it once, with
the bounds of every index (the reference relies on ``promise_in_bounds``;
the kernel has no clamp).

The JAX package jits the evaluator by default (``make_evaluator(jit=True)``);
here ``jit=True`` replays a ``StaticPass``, the same pass on buffers
allocated once, as a CUDA graph (``ops.graphs``), and the default stays
eager.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .lowering import LoweredGraph, lower
from .dtypes import default_device, default_dtype
from .graphs import Captured, require_cuda
from ..utils.profiling import scope
from .kernels import (MAX_N_OP, LevelRun, LevelTables, check_tables, cuda_type_codes,
                      level_gather_reduce, level_gather_reduce_plain, levels_gather_reduce,
                      on_device, pack_level, plan_run)

# the launch plans an evaluator keeps, one a batch size, the newest
PLANS_KEPT = 16


@dataclass
class _Level:
    csr: Optional[tuple]     # (start, count, src, fac, seg)
    tables: Optional[LevelTables]   # the level's buckets and plans, packed (level_buckets)
    prods: List[tuple]       # plain: (start, count, idx [arity, count], factor [count], scope)
    pows: List[tuple]        # plain: (n, start, count, src, factor, scope)
    scope: str               # the level's profiler scope, and its bucket launch's
    bucket_scope: str


def _is_power(plan) -> bool:
    # by its fields, so that the JAX package's plans (the tests') pass too
    return hasattr(plan, "src")


def in_kernel(plan) -> bool:
    """Whether a ``ProdPlan`` or ``PowerPlan`` runs in the level launch:
    arity, or exponent, ``1..MAX_N_OP``."""
    return 1 <= (plan.n if _is_power(plan) else plan.arity) <= MAX_N_OP


def plan_bucket(plan) -> tuple:
    """A ``ProdPlan`` of arity k as the bucket ``(idx [k, 1, count], fac
    [1, count], start)``: one term of k operands; a ``PowerPlan`` of n as
    the bucket of one term whose operand is its row, n times."""
    if _is_power(plan):
        idx = np.repeat(np.asarray(plan.src)[None, None], plan.n, axis=0)
    else:
        idx = np.asarray(plan.idx)[:, None]
    return idx, np.asarray(plan.factor)[None], plan.start


def level_buckets(lvl) -> list:
    """The buckets ``(idx [n_op, arity, count], fac, start)`` of a
    ``LevelPlan`` that its one launch computes: its sum buckets (``n_op``
    1), its fused buckets, then its products and powers that ``in_kernel``
    admits (``plan_bucket``)."""
    return ([(np.asarray(sb.idx)[None], np.asarray(sb.fac), sb.start)
             for sb in lvl.sum_buckets]
            + [(np.asarray(fb.idx), np.asarray(fb.fac), fb.start) for fb in lvl.fused]
            + [plan_bucket(p) for p in list(lvl.prods) + list(lvl.pows) if in_kernel(p)])


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


def unwritten_reads(lowered: LoweredGraph):
    """The rows that a pass reads before it writes them, as two int64
    arrays: those that no plan of the pass writes (a static buffer zeroes
    them once), and those that a later plan writes (zeroed before every
    pass).  A pass writes the leaf and constant rows first, then each
    level's plans; a level reads only rows of earlier writes
    (``check_lowered``), and the roots are read at the end.  Padding terms
    read the leaf row 0 or a constant slot, and padded bucket rows are
    written by the kernel, so on the lowerings of this package both arrays
    are empty."""
    n = lowered.num_slots
    written = np.zeros(n, bool)
    written[:lowered.num_leaves] = True
    unread = np.zeros(n, bool)      # read before any write of the pass
    later = np.zeros(n, bool)       # ... and written afterwards
    for lvl in lowered.levels:
        plans = ([(lvl.sums.start, lvl.sums.count, lvl.sums.edge_src)]
                 if lvl.sums is not None else [])
        plans += [(b.start, b.count, b.idx) for b in list(lvl.sum_buckets) + list(lvl.fused)]
        plans += [(p.start, p.count, p.idx) for p in lvl.prods]
        plans += [(pw.start, pw.count, pw.src) for pw in lvl.pows]
        for _, _, read in plans:
            read = np.asarray(read, np.int64).ravel()
            unread[read[~written[read]]] = True
        for start, count, _ in plans:
            later[start:start + count] |= unread[start:start + count]
            written[start:start + count] = True
    roots = np.asarray(lowered.root_slots, np.int64)
    unread[roots[~written[roots]]] = True
    return np.flatnonzero(unread & ~later), np.flatnonzero(later)


def unwritten_rows(lowered: LoweredGraph) -> np.ndarray:
    """The rows that no part of a pass writes (not a leaf or constant row,
    nor in any plan's output rows), as int64: an eager pass that returns
    its whole buffer zeroes them, so that it shows no stale row."""
    written = np.zeros(lowered.num_slots, bool)
    written[:lowered.num_leaves] = True
    for lvl in lowered.levels:
        plans = [lvl.sums] if lvl.sums is not None else []
        for p in plans + list(lvl.sum_buckets) + list(lvl.fused) + list(lvl.prods) \
                + list(lvl.pows):
            written[p.start:p.start + p.count] = True
    return np.flatnonzero(~written)


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
                 for p in lvl.prods if not in_kernel(p)]
        pows = [(pw.n, pw.start, pw.count, i64(pw.src), f(pw.factor), f"pow{pw.n}")
                for pw in lvl.pows if not in_kernel(pw)]
        only_sums = len(buckets) == len(lvl.sum_buckets)
        levels.append(_Level(csr, tables, prods, pows, f"gL{li:02d}",
                             f"{'sb' if only_sums else 'fb'}{len(buckets)}"))
    return levels


def cut_runs(levels: List[_Level]) -> List[Union[_Level, List[_Level]]]:
    """A pass's steps in order, level by level: a level's CSR sum, then its
    launch, then its plain products and powers.  Each Python part is a step
    of its own, a ``_Level`` without tables; the launches between two such
    parts form a run, a list of the levels that launch (``_Level.tables``).
    No plan of a level reads a row that the level writes
    (``check_lowered``), so a level's parts may run in any order."""
    steps: List[Union[_Level, List[_Level]]] = []
    for lvl in levels:
        if lvl.csr is not None:
            steps.append(replace(lvl, tables=None, prods=[], pows=[]))
        if lvl.tables is not None:
            if not steps or not isinstance(steps[-1], list):
                steps.append([])
            steps[-1].append(lvl)
        if lvl.prods or lvl.pows:
            steps.append(replace(lvl, csr=None, tables=None))
    return steps


def launch_plan(ev: "Evaluator", w: torch.Tensor) -> list:
    """``ev``'s steps (``Evaluator.steps``) at ``w``'s batch size, each run
    prepared as a ``LevelRun`` (``kernels.plan_run``): what a pass on
    buffers of ``w``'s shape launches.  ``launch_plan.built`` counts the
    plans built."""
    launch_plan.built += 1
    return [plan_run(w, [lvl.tables for lvl in step],
                     [f"{lvl.scope}/{lvl.bucket_scope}" for lvl in step],
                     compensated=ev.compensated, acc_dtype=ev.acc_dtype)
            if isinstance(step, list) else step for step in ev.steps]


launch_plan.built = 0


def _eval_levels(levels: List[_Level], w: torch.Tensor, acc_dtype=None,
                 compensated: bool = False, chunk_rows: Optional[int] = None,
                 kernel: bool = True) -> torch.Tensor:
    """Run all levels on ``w`` in place and return it.

    ``acc_dtype`` widens arithmetic: gathered rows are upcast, the plan
    computes in ``acc_dtype`` and stores back at ``w.dtype``.
    ``compensated`` switches every bucket reduction to Kahan summation.
    ``kernel=False`` runs the buckets through the plain version on any
    device (the reference the kernel is checked against).  An evaluator on
    CUDA with the kernel passes only levels without tables here (the
    Python parts of ``cut_runs``)."""
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


class StaticPass:
    """The graph pass at one batch size on buffers allocated once: what a
    CUDA graph captures (``ops.graphs``).

    ``w`` is the weight buffer ``[num_slots, batch]``, ``leaves`` its leaf
    rows (a view, which the caller or the leaf phase fills before each
    ``run``) and ``roots`` the roots' output.  Only the rows that a pass
    reads before it writes them (``unwritten_reads``) are zeroed, once,
    here.  The constant rows are written by every ``run``, as by the eager
    pass: no plan of this package's lowerings takes a constant's slot, but
    nothing in a lowering forbids it.  ``run()`` does the pass in place and
    returns ``roots``: it allocates nothing outside a graph's pool and never
    waits for the host."""

    def __init__(self, ev: "Evaluator", batch: int):
        self._ev = ev
        self.w = torch.empty((ev.num_slots, batch), dtype=ev.dtype, device=ev.device)
        self.w[ev.zero_rows] = 0
        self.leaves = self.w[:ev.nl_input]
        self.roots = torch.empty((len(ev.root_slots), batch), dtype=ev.acc_dtype or ev.dtype,
                                 device=ev.device)

    def run(self) -> torch.Tensor:
        ev = self._ev
        if ev.rezero_rows is not None:
            self.w[ev.rezero_rows] = 0
        if ev.n_const:
            self.w[ev.nl_input:ev.nl_input + ev.n_const] = ev.const_values[:, None]
        ev.eval_levels(self.w)
        self.roots.copy_(self.w[ev.root_slots])
        return self.roots


class Evaluator:
    """``f(leaf_values[num_leaves, batch]) -> roots[num_roots, batch]``, run
    eagerly; ``static_pass(batch)`` gives the same pass on static buffers
    (``make_evaluator`` has the arguments)."""

    def __init__(self, lowered: LoweredGraph, device: torch.device, dtype, return_all: bool,
                 acc_dtype, compensated: bool, chunk_rows: Optional[int], kernel: bool):
        check_lowered(lowered)
        self.device, self.dtype, self.acc_dtype = device, dtype, acc_dtype
        self.return_all, self.compensated = return_all, compensated
        self.chunk_rows, self.kernel = chunk_rows, kernel
        self.num_slots = lowered.num_slots
        self.n_const = len(lowered.const_slots)
        self.nl_input = lowered.num_leaves - self.n_const
        self.const_values = torch.as_tensor(np.asarray(lowered.const_values),
                                            device=device).to(dtype)
        self.root_slots = torch.as_tensor(np.asarray(lowered.root_slots, np.int64),
                                          device=device)
        zero, rezero = unwritten_reads(lowered)
        self.zero_rows = torch.as_tensor(zero, device=device)
        self.rezero_rows = torch.as_tensor(rezero, device=device) if rezero.size else None
        # an eager pass's buffer: the rows read before written, and with
        # return_all those never written, zeroed; all others are written
        eager = np.concatenate([zero, rezero] + ([unwritten_rows(lowered)] if return_all
                                                 else []))
        self.eager_zero_rows = torch.as_tensor(np.unique(eager), device=device) \
            if eager.size else None
        self.levels = _upload(lowered, device, acc_dtype or dtype)
        # the launch path: the pass cut into runs and Python parts, checked
        # once here
        self.steps = None
        if kernel and device.type == "cuda":
            self.steps = cut_runs(self.levels)
            self.device_at = self.root_slots.device       # with its index
            cuda_type_codes(dtype, acc_dtype or dtype, acc_dtype)
            for lvl in self.levels:
                if lvl.tables is not None:
                    check_tables(lvl.tables, self.num_slots, self.device_at)
        self._plans: Dict[int, list] = {}

    def leaf_input(self, leaf_values) -> torch.Tensor:
        """``leaf_values`` as a ``[rows, batch]`` tensor of the storage type
        on the device."""
        leaf_values = torch.as_tensor(leaf_values, device=self.device).to(self.dtype)
        return leaf_values[:, None] if leaf_values.dim() == 1 else leaf_values

    def __call__(self, leaf_values) -> torch.Tensor:
        leaf_values = self.leaf_input(leaf_values)
        w = self.buffer(leaf_values.shape[1])
        n = len(leaf_values)
        w[:n] = leaf_values
        if n < self.nl_input:
            w[n:self.nl_input] = 0
        return self.run(w)

    def buffer(self, batch: int) -> torch.Tensor:
        """The weight buffer ``[num_slots, batch]`` of one eager pass, from
        ``torch.empty``: only the rows that the pass reads before it writes
        them (none in this package's lowerings) and, with ``return_all``,
        the rows that it never writes are zeroed.  Its first ``nl_input``
        rows are the leaf rows, which the caller writes (the leaf phase,
        straight into them) before ``run``."""
        w = torch.empty((self.num_slots, batch), dtype=self.dtype, device=self.device)
        if self.eager_zero_rows is not None:
            w[self.eager_zero_rows] = 0
        return w

    def run(self, w: torch.Tensor) -> torch.Tensor:
        """The eager pass on ``w`` (``buffer``, its leaf rows written): the
        constant rows, every level in place, then the roots (profiler scope
        ``roots``), or ``w`` with ``return_all``."""
        if self.n_const:
            w[self.nl_input:self.nl_input + self.n_const] = self.const_values[:, None]
        self.eval_levels(w)
        if self.return_all:
            return w
        with scope("roots"):
            out = w[self.root_slots]
            return out.to(self.acc_dtype) if self.acc_dtype is not None else out

    def eval_levels(self, w: torch.Tensor) -> torch.Tensor:
        """Run every level on ``w`` (``[num_slots, batch]`` of the storage
        type) in place and return it.  On CUDA with the kernel the pass
        launches from the launch plan of ``w``'s batch (``launch_plan``,
        built at the first pass of that batch and kept): each run one
        ``levels_gather_reduce`` on the current stream, each Python part of
        a level through ``_eval_levels``; elsewhere every level runs through
        ``_eval_levels``."""
        if self.steps is None:
            return _eval_levels(self.levels, w, self.acc_dtype, self.compensated,
                                self.chunk_rows, self.kernel)
        if w.shape[0] != self.num_slots or w.dtype != self.dtype \
                or w.device != self.device_at or not w.is_contiguous():
            raise ValueError(f"w must be a contiguous {self.dtype} [{self.num_slots}, batch] "
                             f"tensor on {self.device_at}, got {w.dtype} {tuple(w.shape)} on "
                             f"{w.device}")
        plan = self._plans.get(w.shape[1])
        if plan is None:
            if len(self._plans) >= PLANS_KEPT:
                del self._plans[next(iter(self._plans))]
            plan = self._plans[w.shape[1]] = launch_plan(self, w)
        with on_device(self.device_at):
            stream = torch.cuda.current_stream(self.device_at).cuda_stream
            for step in plan:
                if isinstance(step, LevelRun):
                    levels_gather_reduce(w, step, stream)
                else:
                    _eval_levels([step], w, self.acc_dtype, self.compensated, self.chunk_rows)
        return w

    def static_pass(self, batch: int) -> StaticPass:
        """A new ``StaticPass`` of this evaluator at ``batch``."""
        return StaticPass(self, batch)


def make_evaluator(lowered: LoweredGraph, *, device=None, dtype=None,
                   return_all: bool = False, acc_dtype=None,
                   compensated: bool = False, chunk_rows: Optional[int] = None,
                   kernel: bool = True, jit: bool = False):
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

    ``jit=True``, the counterpart of the JAX function's default, returns a
    function that copies ``leaf_values`` (all ``nl`` rows) into the leaf
    rows of a ``StaticPass``, replays the pass as a CUDA graph captured at
    the first call of each batch size, and returns a fresh tensor of the
    roots.  It holds one batch size at a time: a new one frees the old
    graph and buffers.  It needs a CUDA ``device`` (``ValueError``
    otherwise) and runs no ``return_all``.  The default stays eager: on the
    CPU there is no graph.  The launch counters count a replay's launches
    as an eager pass's, from the graph's launch manifest, and its replay
    runs in the scope ``replay:<name>`` (``ops.graphs.replay``).
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    a = acc_dtype or dtype
    if jit:
        require_cuda(device, "make_evaluator")
        if return_all:
            raise ValueError("make_evaluator(jit=True) returns the roots: return_all=True "
                             "runs eagerly")
    if kernel and device.type == "cuda":
        cuda_type_codes(dtype, a, acc_dtype)
    ev = Evaluator(lowered, device, dtype, return_all, acc_dtype, compensated, chunk_rows,
                   kernel)
    if not jit:
        return ev

    def prepare(leaf_values):
        sp = ev.static_pass(leaf_values.shape[1])
        return [sp.leaves], sp.run

    captured = Captured(prepare)

    def evaluate(leaf_values) -> torch.Tensor:
        leaf_values = ev.leaf_input(leaf_values)
        if leaf_values.shape[0] != ev.nl_input:
            raise ValueError(f"jit=True takes all {ev.nl_input} leaf rows, got "
                             f"{leaf_values.shape[0]}")
        return captured(leaf_values)

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
