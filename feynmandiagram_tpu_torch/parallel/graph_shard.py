"""Memory-partitioned (graph-sharded) evaluation over a mesh axis.

Port of ``feynmandiagram_tpu/parallel/graph_shard.py``.  For DAGs too large
to evaluate on one device at full batch (BASELINE config 5) the slot space
itself is partitioned: rank d of the ``graph`` axis owns the leaf-block
shard plus an equal chunk of every bucket's output rows, so its weight
buffer holds ~``live_slots / n`` rows, not a replica of the full buffer.
Per topological level:

1. every rank gathers, from its *local* buffer, the rows it owns among the
   union of slots read at this level (its send block, padded to the
   per-level maximum H_l);
2. ``Mesh.all_gather`` over the graph axis assembles the level's halo
   buffer ``[n*H_l, batch]``.  The exchange is split in two: rows produced
   at the immediately preceding level ride a "late" gather, rows produced
   earlier an "early" gather taken before the previous level's compute.
   Eager PyTorch does not overlap the two, but the halo's layout, and so
   the index remap, depends on the split, which is kept as in the JAX
   package;
3. each rank computes its chunk of every group reading only from the halo
   (operand indices are remapped host-side to halo positions) and writes
   the chunk at its local offset: the level's ``sum`` and ``fused`` groups
   and its ``prod`` and ``pow`` groups in one launch of the gather-reduce
   kernel (``level_gather_reduce`` with ``src=halo``), as the unsharded
   evaluator packs them; a ``prod`` or ``pow`` of arity or exponent above
   ``MAX_N_OP`` (no configuration of this package has one) as plain
   PyTorch in the unsharded evaluator's arithmetic.

The ranks of the graph axis that a process holds are stepped together,
level by level: every rank's send block is gathered before any rank
computes, so one body serves a local mesh, a distributed one and a mix.
Ownership of global slots is single-assignment (the lowering must use
``reuse_slots=False``), and each rank recycles its local rows with the
lifetime-based allocator the single-device lowering uses.  Rows are owned
contiguously or round-robin, whichever pads the halos less.  Root rows are
assembled with one final exchange.  Composes with batch-axis data
parallelism on a 2-D (graph x batch) mesh.

The planner (``_plan`` and its helpers, ``_resolve_plan``,
``lower_sharded_best``) is the JAX package's numpy code, copied with
unchanged behaviour.  The JAX package's ``layout='tile'``, the TPU's
tile-row form, is not ported.

The JAX package jits the sharded evaluator and runs the sharded MC step's
iterations in one ``fori_loop`` under one ``jax.jit``.  Here both run
eagerly by default; ``jit=True`` replays a ``StaticShardedPass`` (every
rank's buffers allocated once, no zero-fill, no wait for the host) as a
CUDA graph (``ops.graphs``): the evaluator's whole pass, and one iteration
of the MC step over every rank held here, replayed ``iters`` times.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dtypes import default_dtype
from ..ops.graphs import Captured, SeededGraph, one_shape, require_cuda
from ..ops.kernels import MAX_N_OP, LevelTables, level_gather_reduce, pack_level
from ..ops.lowering import LoweredGraph, TILE_ROWS, _pad_to
from .sharding import BATCH_AXIS, Mesh, _rank_columns, rank_seed

GRAPH_AXIS = "graph"


@dataclass
class _ShardedGroup:
    """One bucket of one level, chunked across devices.

    Index arrays are already remapped to halo positions and reshaped so
    axis -2 is the device axis (each device dynamic-indexes its chunk).
    """
    kind: str                 # 'sum' | 'fused' | 'prod' | 'pow'
    local_off: np.ndarray     # [n] per-device output offset in local buffer
    chunk: int                # output rows per device
    idx: np.ndarray           # sum: [A, n, chunk]; fused: [K, A, n, chunk];
                              # prod: [A, n, chunk]; pow: [n, chunk]
    fac: np.ndarray           # sum/fused: [A, n, chunk]; prod/pow: [n, chunk]
    pow_n: int = 0


@dataclass
class _LevelSched:
    early_send: np.ndarray    # [n, He] local rows for the EARLY halo
    late_send: np.ndarray     # [n, Hl] local rows for the LATE halo
    groups: List[_ShardedGroup]
    early_rows: int           # n * He
    late_rows: int            # n * Hl
    read_rows: int            # true union size (pre-padding)


@dataclass
class ShardStats:
    """Memory/communication footprint of a graph-sharded plan."""
    n_dev: int
    full_slots: int           # slots of the unsharded (reuse_slots=False) buffer
    local_slots: int          # per-device buffer rows (max over devices)
    halo_rows_per_level: List[int]     # early + late, per level (+ roots)
    read_rows_per_level: List[int]
    early_rows_per_level: List[int] = field(default_factory=list)
    interleaved: bool = False

    def halo_bytes_per_sample(self, itemsize: int = 4) -> int:
        """Bytes received per device per batch element over a full pass."""
        return sum(self.halo_rows_per_level) * itemsize

    @property
    def halo_pad_overhead(self) -> float:
        """Exchanged rows / true boundary rows (1.0 = no padding waste)."""
        return sum(self.halo_rows_per_level) / max(sum(self.read_rows_per_level), 1)

    @property
    def early_share(self) -> float:
        """Fraction of halo rows on the EARLY (compute-overlapped) gather."""
        tot = sum(self.halo_rows_per_level)
        return sum(self.early_rows_per_level) / max(tot, 1)


class _LocalPool:
    """Per-device contiguous-interval first-fit allocator (local rows)."""

    def __init__(self, top: int):
        self.top = top
        self.intervals: List[List[int]] = []
        self.pending: List[int] = []

    def free(self, slots) -> None:
        self.pending.extend(slots)

    def _merge(self) -> None:
        if not self.pending:
            return
        ivs = self.intervals + [[p, p + 1] for p in self.pending]
        self.pending = []
        ivs.sort()
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        self.intervals = merged

    def alloc(self, count: int, align: int = 1) -> int:
        self._merge()
        for k, (s, e) in enumerate(self.intervals):
            s_al = _pad_to(s, align)
            if e - s_al >= count:
                if s_al > s:
                    self.intervals[k] = [s, s_al]
                    if e > s_al + count:
                        self.intervals.insert(k + 1, [s_al + count, e])
                elif e - s == count:
                    del self.intervals[k]
                else:
                    self.intervals[k][0] = s + count
                return s_al
        s = _pad_to(self.top, align)
        if s > self.top:
            self.intervals.append([self.top, s])
            self.intervals.sort()
        self.top = s + count
        return s


def _collect_groups(lowered: LoweredGraph):
    """[(level, kind, plan)] in evaluation order."""
    if any(lvl.sums is not None for lvl in lowered.levels):
        raise ValueError(
            "graph-sharded evaluation requires sum_mode='bucketed' or 'fused' "
            "(csr segment-sums scatter across the slot partition)")
    out = []
    for li, lvl in enumerate(lowered.levels):
        plans = ([("sum", sb) for sb in lvl.sum_buckets]
                 + [("fused", fb) for fb in lvl.fused]
                 + [("prod", p) for p in lvl.prods]
                 + [("pow", pw) for pw in lvl.pows])
        for kind, plan in plans:
            out.append((li, kind, plan))
    return out


def _reads_of(kind: str, plan) -> np.ndarray:
    if kind in ("sum", "fused", "prod"):
        return np.asarray(plan.idx).ravel()
    return np.asarray(plan.src).ravel()


def _plan(lowered: LoweredGraph, n_dev: int, *, interleave: bool = False,
          local_reuse: bool = True) -> Tuple[List[_LevelSched], ShardStats,
                                             np.ndarray, np.ndarray, int]:
    """Host-side planner: ownership map, per-device local layouts (with
    lifetime-based reuse), per-level split halo schedules, root plan.

    Returns (levels, stats, root_send_idx[n, Hr], root_pos[R], leaf_chunk).
    """
    num_slots = lowered.num_slots
    nl = lowered.num_leaves
    n_levels = len(lowered.levels)
    leaf_chunk = _pad_to(nl, n_dev) // n_dev

    groups = _collect_groups(lowered)

    # ---- ownership (global slot -> device, chunk position)
    owner = np.full(num_slots, -1, np.int32)
    chunk_pos = np.full(num_slots, -1, np.int32)   # position within the chunk
    write_level = np.full(num_slots, -1, np.int32)  # level producing the slot
    s = np.arange(nl)
    owner[s] = s // leaf_chunk                      # leaves: contiguous (input
    chunk_pos[s] = s % leaf_chunk                   # sharding is contiguous)
    write_level[s] = -1

    meta = []  # per group: (level, kind, plan, chunk)
    for li, kind, plan in groups:
        count, start = plan.count, plan.start
        chunk = _pad_to(count, n_dev) // n_dev
        ks = np.arange(count)
        if (owner[start + ks] != -1).any():
            raise ValueError(
                "slot ownership conflict: lower with reuse_slots=False "
                "for graph-sharded evaluation")
        if interleave:
            owner[start + ks] = ks % n_dev
            chunk_pos[start + ks] = ks // n_dev
        else:
            owner[start + ks] = ks // chunk
            chunk_pos[start + ks] = ks % chunk
        write_level[start + ks] = li
        meta.append((li, kind, plan, chunk))

    # ---- lifetimes: last level (or root epoch) reading each global slot
    ROOT_EPOCH = n_levels
    last_read = np.full(num_slots, -1, np.int32)
    for li, kind, plan in groups:
        rd = np.unique(_reads_of(kind, plan))
        last_read[rd] = np.maximum(last_read[rd], li)
    roots = np.asarray(lowered.root_slots)
    last_read[roots] = ROOT_EPOCH

    # ---- per-device local layout with lifetime reuse
    local = np.full((n_dev, num_slots), -1, np.int32)
    local_offs: Dict[int, np.ndarray] = {}
    for d in range(n_dev):
        mine = s[owner[s] == d]
        local[d, mine] = chunk_pos[mine]            # leaf rows pinned at 0..
    if local_reuse:
        pools = [_LocalPool(leaf_chunk) for _ in range(n_dev)]
        # free queue: level -> per-device list of local rows
        free_at: List[List[List[int]]] = [
            [[] for _ in range(n_dev)] for _ in range(n_levels + 1)]
        cur_level = 0
        for gi, (li, kind, plan, chunk) in enumerate(meta):
            while cur_level < li:
                for d in range(n_dev):
                    pools[d].free(free_at[cur_level][d])
                cur_level += 1
            count, start = plan.count, plan.start
            gslots = start + np.arange(count)
            offs = np.zeros(n_dev, np.int32)
            for d in range(n_dev):
                off = pools[d].alloc(chunk, TILE_ROWS)
                offs[d] = off
                mine = gslots[owner[gslots] == d]
                local[d, mine] = off + chunk_pos[mine]
                for g in mine:
                    lr = last_read[g]
                    if lr < ROOT_EPOCH:
                        free_at[max(lr, li)][d].append(local[d, g])
                # chunk-padding rows (no global slot) free immediately
                used = set(chunk_pos[mine].tolist())
                free_at[li][d].extend(off + p for p in range(chunk)
                                      if p not in used)
            local_offs[gi] = offs
        local_top = max(p.top for p in pools) if pools else leaf_chunk
    else:
        local_top = leaf_chunk
        for gi, (li, kind, plan, chunk) in enumerate(meta):
            # TILE_ROWS-align each group's offset, as the reuse branch does
            local_top = _pad_to(local_top, TILE_ROWS)
            count, start = plan.count, plan.start
            gslots = start + np.arange(count)
            for d in range(n_dev):
                mine = gslots[owner[gslots] == d]
                local[d, mine] = local_top + chunk_pos[mine]
            local_offs[gi] = np.full(n_dev, local_top, np.int32)
            local_top += chunk

    # ---- halo schedules (early/late split)
    def halo_schedule(read_slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """(send_idx[n, H], pos[num_slots], n*H) for a set of read global
        slots: pos[s] = position of row s in the gathered halo."""
        own = owner[read_slots]
        counts = np.bincount(own, minlength=n_dev)
        H = max(int(counts.max()), 1) if len(read_slots) else 1
        send_idx = np.zeros((n_dev, H), np.int32)
        pos = np.full(num_slots, 0, np.int32)
        for d in range(n_dev):
            mine = read_slots[own == d]
            send_idx[d, :len(mine)] = local[d, mine]
            pos[mine] = d * H + np.arange(len(mine))
        return send_idx, pos, n_dev * H

    levels: List[_LevelSched] = []
    halo_rows_per_level: List[int] = []
    early_rows_per_level: List[int] = []
    read_rows_per_level: List[int] = []
    by_level: List[List[Tuple[int, str, object, int]]] = [[] for _ in range(n_levels)]
    for gi, (li, kind, plan, chunk) in enumerate(meta):
        by_level[li].append((gi, kind, plan, chunk))

    for li in range(n_levels):
        lvl_groups = by_level[li]
        reads = [_reads_of(kind, plan) for _, kind, plan, _ in lvl_groups]
        read_slots = (np.unique(np.concatenate(reads)) if reads
                      else np.zeros(0, np.int64))
        # EARLY: produced strictly before the previous level (or leaves) —
        # exchangeable while level li-1 computes.  LATE: produced at li-1.
        late_mask = write_level[read_slots] == li - 1
        early_slots = read_slots[~late_mask]
        late_slots = read_slots[late_mask]
        early_send, early_pos, early_rows = halo_schedule(early_slots)
        late_send, late_pos, late_rows = halo_schedule(late_slots)
        # combined halo = [early | late]: late positions shift by early_rows
        pos = early_pos.copy()
        pos[late_slots] = late_pos[late_slots] + early_rows

        sched_groups: List[_ShardedGroup] = []
        for gi, kind, plan, chunk in lvl_groups:
            count_p = chunk * n_dev

            def pad_cols(a: np.ndarray, fill=0) -> np.ndarray:
                """Pad the trailing (node) axis to count_p, then split it
                into [n_dev, chunk] (device-major or interleaved to match
                the ownership layout)."""
                out = np.full(a.shape[:-1] + (count_p,), fill, a.dtype)
                out[..., :a.shape[-1]] = a
                if interleave:
                    return out.reshape(
                        a.shape[:-1] + (chunk, n_dev)).swapaxes(-1, -2)
                return out.reshape(a.shape[:-1] + (n_dev, chunk))

            offs = local_offs[gi]
            if kind == "sum":
                sched_groups.append(_ShardedGroup(
                    "sum", offs, chunk, pad_cols(pos[plan.idx]),
                    pad_cols(plan.fac, 0)))
            elif kind == "fused":
                sched_groups.append(_ShardedGroup(
                    "fused", offs, chunk, pad_cols(pos[plan.idx]),
                    pad_cols(plan.fac, 0)))
            elif kind == "prod":
                sched_groups.append(_ShardedGroup(
                    "prod", offs, chunk, pad_cols(pos[plan.idx]),
                    pad_cols(plan.factor, 0)))
            else:
                sched_groups.append(_ShardedGroup(
                    "pow", offs, chunk, pad_cols(pos[plan.src]),
                    pad_cols(plan.factor, 0), pow_n=plan.n))
        levels.append(_LevelSched(early_send, late_send, sched_groups,
                                  early_rows, late_rows, len(read_slots)))
        halo_rows_per_level.append(early_rows + late_rows)
        early_rows_per_level.append(early_rows)
        read_rows_per_level.append(len(read_slots))

    root_send_idx, root_pos_map, root_halo = halo_schedule(roots)
    root_pos = root_pos_map[roots]
    halo_rows_per_level.append(root_halo)
    early_rows_per_level.append(0)
    read_rows_per_level.append(len(np.unique(roots)))

    stats = ShardStats(n_dev, num_slots, local_top, halo_rows_per_level,
                       read_rows_per_level, early_rows_per_level, interleave)
    return levels, stats, root_send_idx, root_pos, leaf_chunk



def _resolve_plan(lowered: LoweredGraph, n_dev: int,
                  interleave: Optional[bool], local_reuse: bool):
    """Plan both ownership layouts when ``interleave`` is None and keep the
    one with less total halo traffic."""
    if interleave is None:
        plans = [_plan(lowered, n_dev, interleave=i, local_reuse=local_reuse)
                 for i in (False, True)]
        plans.sort(key=lambda p: sum(p[1].halo_rows_per_level))
        return plans[0]
    return _plan(lowered, n_dev, interleave=interleave,
                 local_reuse=local_reuse)



def sharded_unwritten_reads(levels: List[_LevelSched], root_send_idx: np.ndarray,
                            leaf_chunk: int, local_slots: int, d: int):
    """The rows of rank ``d``'s buffer that a sharded pass reads before it
    writes them, as ``ops.evaluator.unwritten_reads`` gives them for the
    unsharded buffer: those that no group of the pass writes (a static
    buffer zeroes them once), and those that a later group writes (zeroed
    before every pass).  A pass writes the leaf rows first; a rank's buffer
    is read only through its send tables, in the order of
    ``_DeviceEval.halos``: level 0's early rows, then for each level its
    late rows and the next level's early rows before the level's groups
    write their chunks; the root send table at the end.  The groups read
    only the halo, every row of which the exchange writes.  Padded send
    entries read the leaf row 0, and padded chunk rows are written with
    their group's, so on the plans of this package both arrays are
    empty."""
    written = np.zeros(local_slots, bool)
    written[:leaf_chunk] = True
    unread = np.zeros(local_slots, bool)     # read before any write of the pass
    later = np.zeros(local_slots, bool)      # ... and written afterwards

    def read(rows) -> None:
        rows = np.asarray(rows, np.int64).ravel()
        unread[rows[~written[rows]]] = True

    if levels:
        read(levels[0].early_send[d])
    for li, lv in enumerate(levels):
        read(lv.late_send[d])
        if li + 1 < len(levels):
            read(levels[li + 1].early_send[d])
        for g in lv.groups:
            rows = slice(int(g.local_off[d]), int(g.local_off[d]) + g.chunk)
            later[rows] |= unread[rows]
            written[rows] = True
    read(root_send_idx[d])
    return np.flatnonzero(unread & ~later), np.flatnonzero(later)


def _check_layout(layout: str) -> None:
    if layout != "flat":
        raise ValueError(f"layout={layout!r}: the port has the flat layout only; 'tile' is "
                         f"the TPU's tile-row form and is not ported")


@dataclass
class _RankLevel:
    """One level of one rank on the device: its ``sum`` and ``fused``
    groups and its ``prod`` and ``pow`` groups of arity or exponent
    ``1..MAX_N_OP`` packed for one launch (as ``ops.evaluator.plan_bucket``
    packs them), and the other ``prod`` groups ``(off, chunk, idx [arity,
    chunk], fac [chunk])`` and ``pow`` groups ``(n, off, chunk, src [chunk],
    fac [chunk])``, which run as plain PyTorch."""
    tables: Optional[LevelTables]
    prods: List[tuple]
    pows: List[tuple]


class _DeviceEval:
    """The per-rank evaluation body shared by the sharded evaluator and the
    sharded MC step, for the ranks of the graph axis that this process
    holds.  Tables are built and uploaded once, here; ``levels[l][j]`` is
    level ``l`` of the ``j``-th rank held here.  A call takes one leaf block
    ``[leaf_chunk, batch]`` per such rank and returns the roots
    ``[R, batch]``, which every rank holds after the last exchange."""

    def __init__(self, levels: List[_LevelSched], stats: ShardStats,
                 root_send_idx: np.ndarray, root_pos: np.ndarray, leaf_chunk: int, mesh: Mesh,
                 graph_axis: str, dtype: torch.dtype):
        dev = mesh.device
        self.mesh, self.graph_axis, self.dtype = mesh, graph_axis, dtype
        self.local_slots = stats.local_slots
        ranks = list(mesh.local_ranks(graph_axis))
        # per rank held here, the rows a pass reads before it writes them
        # (sharded_unwritten_reads): zeroed once (zero_rows) or before every
        # pass (rezero_rows, None where there are none)
        self.zero_rows, self.rezero_rows = [], []
        for d in ranks:
            zero, rezero = sharded_unwritten_reads(levels, root_send_idx, leaf_chunk,
                                                   stats.local_slots, d)
            self.zero_rows.append(torch.as_tensor(zero, device=dev))
            self.rezero_rows.append(torch.as_tensor(rezero, device=dev) if rezero.size else None)

        def i64(a) -> torch.Tensor:
            return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=dev)

        def f(a) -> torch.Tensor:
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        self.early = [[i64(lv.early_send[d]) for d in ranks] for lv in levels]
        self.late = [[i64(lv.late_send[d]) for d in ranks] for lv in levels]
        self.root_send = [i64(root_send_idx[d]) for d in ranks]
        self.root_pos = i64(root_pos)
        self.levels: List[List[_RankLevel]] = []
        for lv in levels:
            per_rank = []
            for d in ranks:
                buckets, prods, pows = [], [], []
                for g in lv.groups:
                    off = int(g.local_off[d])
                    if g.kind == "sum":
                        buckets.append((g.idx[:, d, :][None], g.fac[:, d, :], off))
                    elif g.kind == "fused":
                        buckets.append((g.idx[:, :, d, :], g.fac[:, d, :], off))
                    elif g.kind == "prod" and 1 <= g.idx.shape[0] <= MAX_N_OP:
                        # arity k: one term of k operands (ops/evaluator.py::plan_bucket)
                        buckets.append((g.idx[:, d, :][:, None], g.fac[d][None], off))
                    elif g.kind == "prod":
                        prods.append((off, g.chunk, i64(g.idx[:, d, :]), f(g.fac[d])))
                    elif 1 <= g.pow_n <= MAX_N_OP:
                        # exponent n: one term of its row, n times
                        buckets.append((np.repeat(g.idx[d][None, None], g.pow_n, axis=0),
                                        g.fac[d][None], off))
                    else:
                        pows.append((g.pow_n, off, g.chunk, i64(g.idx[d]), f(g.fac[d])))
                tables = pack_level(buckets, dev, dtype) if buckets else None
                per_rank.append(_RankLevel(tables, prods, pows))
            self.levels.append(per_rank)

    def init(self, leaf_blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's buffer ``[local_slots, batch]``: ``torch.empty``, its
        leaf block in the first rows and the rows that a pass reads before
        it writes them zeroed (none on this package's plans); every other
        row is written by the pass."""
        ws = []
        for blk, zero, rezero in zip(leaf_blocks, self.zero_rows, self.rezero_rows):
            w = torch.empty((self.local_slots, blk.shape[1]), dtype=self.dtype,
                            device=self.mesh.device)
            w[:blk.shape[0]] = blk
            for rows in (zero, rezero):
                if rows is not None and rows.numel():
                    w[rows] = 0
            ws.append(w)
        return ws

    def gather(self, ws: List[torch.Tensor], sends: List[torch.Tensor]) -> torch.Tensor:
        """One exchange: each rank's rows ``w[send]``, gathered in rank order."""
        return self.mesh.all_gather(self.graph_axis, [w[s] for w, s in zip(ws, sends)])

    def halos(self, ws: List[torch.Tensor]):
        """Yield ``(level, halo)`` before each level's compute: the halo is
        the early rows, then the late ones; the next level's early halo is
        gathered before this level computes, as in the JAX package."""
        early = self.gather(ws, self.early[0]) if self.levels else None
        for li in range(len(self.levels)):
            late = self.gather(ws, self.late[li])
            nxt = self.gather(ws, self.early[li + 1]) if li + 1 < len(self.levels) else None
            yield li, torch.cat([early, late])
            early = nxt

    def compute(self, li: int, ws: List[torch.Tensor], halo: torch.Tensor) -> None:
        """Level ``li`` of every rank held here, reading ``halo``, in place."""
        for w, lvl in zip(ws, self.levels[li]):
            if lvl.tables is not None:
                level_gather_reduce(w, lvl.tables, src=halo)
            for off, chunk, idx, fac in lvl.prods:
                block = halo[idx[0]]
                for k in range(1, idx.shape[0]):
                    block = block * halo[idx[k]]
                w[off:off + chunk] = block * fac[:, None]
            for n, off, chunk, src, fac in lvl.pows:
                w[off:off + chunk] = torch.pow(halo[src], n) * fac[:, None]

    def roots(self, ws: List[torch.Tensor]) -> torch.Tensor:
        return self.gather(ws, self.root_send)[self.root_pos]

    def run(self, ws: List[torch.Tensor]) -> torch.Tensor:
        """Every level on the buffers ``ws``, their leaf rows filled, in
        place; the roots."""
        for li, halo in self.halos(ws):
            self.compute(li, ws, halo)
        return self.roots(ws)

    def __call__(self, leaf_blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.run(self.init(leaf_blocks))


class _Plan:
    """What the evaluator and the MC step share: the plan, the device body
    and the layout of the leaf rows."""

    def __init__(self, lowered: LoweredGraph, mesh: Mesh, graph_axis: str, dtype,
                 local_reuse: bool, interleave: Optional[bool], layout: str):
        _check_layout(layout)
        self.mesh, self.graph_axis = mesh, graph_axis
        self.dtype = dtype or default_dtype(mesh.device)
        n_dev = mesh.shape[graph_axis]
        levels, self.stats, root_send_idx, root_pos, self.leaf_chunk = _resolve_plan(
            lowered, n_dev, interleave, local_reuse)
        self.device_eval = _DeviceEval(levels, self.stats, root_send_idx, root_pos,
                                       self.leaf_chunk, mesh, graph_axis, self.dtype)
        self.n_const = len(lowered.const_slots)
        self.nl_input = lowered.num_leaves - self.n_const
        self.const_values = torch.as_tensor(np.asarray(lowered.const_values),
                                            device=mesh.device).to(self.dtype)
        self.leaf_rows = self.leaf_chunk * n_dev
        self.ranks = list(mesh.local_ranks(graph_axis))
        self.zero_rows = self.device_eval.zero_rows
        self.rezero_rows = self.device_eval.rezero_rows

    def full(self, batch: int) -> torch.Tensor:
        """The leaf rows of every rank ``[leaf_rows, batch]`` from
        ``torch.empty``: the constants and the zero padding written, the
        first ``nl_input`` rows left for the caller (the leaf phase,
        straight into them)."""
        full = torch.empty((self.leaf_rows, batch), dtype=self.dtype, device=self.mesh.device)
        if self.n_const:
            full[self.nl_input:self.nl_input + self.n_const] = self.const_values[:, None]
        full[self.nl_input + self.n_const:] = 0
        return full

    def split(self, full: torch.Tensor) -> List[torch.Tensor]:
        """The leaf blocks of the ranks held here: each rank's contiguous
        rows of ``full``."""
        c = self.leaf_chunk
        return [full[d * c:(d + 1) * c] for d in self.ranks]

    def blocks(self, leaf_values: torch.Tensor) -> List[torch.Tensor]:
        """The leaf blocks of the ranks held here, for ``leaf_values``
        ``[nl_input, batch]``: the leaf rows with the constants and zero
        padding after them, each rank's a contiguous block."""
        full = self.full(leaf_values.shape[1])
        full[:self.nl_input] = leaf_values
        return self.split(full)

    def eval(self, leaf_values: torch.Tensor) -> torch.Tensor:
        return self.device_eval(self.blocks(leaf_values))

    def static_pass(self, batch: int) -> "StaticShardedPass":
        """A new ``StaticShardedPass`` of this plan at ``batch``."""
        return StaticShardedPass(self, batch)


class StaticShardedPass:
    """The sharded pass at one batch size on buffers allocated once: what a
    CUDA graph captures, the counterpart of ``ops.evaluator.StaticPass``.

    ``full`` is the leaf rows of every rank ``[leaf_rows, batch]``, its
    constant rows and zero padding written here, once; ``leaves`` is its
    first ``nl_input`` rows (a view, which the caller or the leaf phase
    fills before each ``run``).  ``ws`` holds each rank's buffer
    ``[local_slots, batch]``, of which only the rows that
    ``sharded_unwritten_reads`` names (``zero_rows``, a tensor a rank) are
    zeroed, once.  ``run()`` copies
    each rank's leaf block into its buffer's first rows, runs the levels in
    place and returns the roots ``[R, batch]``: the halos and the roots are
    gathered into new tensors (from a graph's pool, under capture), and
    nothing waits for the host."""

    def __init__(self, plan: _Plan, batch: int):
        dev, dtype = plan.mesh.device, plan.dtype
        self._plan = plan
        self.full = torch.zeros((plan.leaf_rows, batch), dtype=dtype, device=dev)
        if plan.n_const:
            self.full[plan.nl_input:plan.nl_input + plan.n_const] = plan.const_values[:, None]
        self.leaves = self.full[:plan.nl_input]
        self.ws = [torch.empty((plan.stats.local_slots, batch), dtype=dtype, device=dev)
                   for _ in plan.ranks]
        self.zero_rows = plan.zero_rows
        for w, rows in zip(self.ws, self.zero_rows):
            w[rows] = 0

    def run(self) -> torch.Tensor:
        plan, c = self._plan, self._plan.leaf_chunk
        for w, d, rows in zip(self.ws, plan.ranks, plan.rezero_rows):
            if rows is not None:
                w[rows] = 0
            w[:c].copy_(self.full[d * c:(d + 1) * c])
        return plan.device_eval.run(self.ws)


class _Sharded:
    """Callable wrapper carrying the planner footprint as ``.stats``, the
    device body as ``.device_eval``, the leaf blocks of the ranks held
    here as ``.blocks(leaf_values)`` and the plan's static pass at a batch
    size as ``.static_pass(batch)``."""

    def __init__(self, fn, plan: _Plan):
        self._fn = fn
        self.stats = plan.stats
        self.device_eval = plan.device_eval
        self.blocks = plan.blocks
        self.static_pass = plan.static_pass

    def __call__(self, leaf_values):
        return self._fn(leaf_values)


def lower_sharded_best(roots, leafmap, n_dev: int, *, sum_mode: str = "fused",
                       cse: bool = True, interleave: Optional[bool] = None,
                       local_reuse: bool = True, **lower_kw):
    """Lower ``roots`` for graph sharding with the level schedule that
    minimizes the per-device footprint on an ``n_dev`` mesh.

    Neither schedule dominates for the sharded planner (the JAX package
    measured ALAP winning orders 3-4 and ASAP order 5), so the generate-once
    workflow lowers under BOTH and keeps the plan with fewer local slots
    (halo rows break ties).  Returns ``(lowered, schedule)``; pass the
    lowering to ``make_graph_sharded_evaluator``/``make_graph_sharded_mc_step``.
    """
    from ..ops.lowering import lower

    best = None
    for sched in ("alap", "asap"):
        low = lower(roots, leafmap, sum_mode=sum_mode, cse=cse,
                    reuse_slots=False, schedule=sched, **lower_kw)
        _, stats, *_ = _resolve_plan(low, n_dev, interleave, local_reuse)
        key = (stats.local_slots, sum(stats.halo_rows_per_level))
        if best is None or key < best[0]:
            best = (key, low, sched)
    return best[1], best[2]



def make_graph_sharded_evaluator(lowered: LoweredGraph, mesh: Mesh, *,
                                 graph_axis: str = GRAPH_AXIS,
                                 batch_axis: Optional[str] = None,
                                 dtype=None, local_reuse: bool = True,
                                 interleave: Optional[bool] = None,
                                 layout: str = "flat", jit: bool = False):
    """Build ``f(leaf_values[num_leaves, batch]) -> roots[R, batch]`` with a
    slot-partitioned weight buffer: each rank holds ``stats.local_slots``
    rows (~``live_slots / n`` with the default per-rank reuse) plus the
    transient per-level halo buffers.  ``leaf_values`` covers the
    non-constant leaf slots, as ``ops.evaluator.make_evaluator``'s.  With
    ``batch_axis`` the batch is split over that axis (it must divide by the
    axis's size) and the roots are gathered.  The returned function carries
    the planner's footprint as ``.stats``.  ``dtype`` defaults to float32
    on CUDA and float64 on the CPU; ``interleave=None`` plans both
    ownership layouts and keeps the one with less total halo traffic.
    ``layout`` must be ``'flat'``.

    ``jit=True``, the counterpart of the JAX function's ``jax.jit``, returns
    a function that copies ``leaf_values`` (all ``nl`` rows) into a
    ``StaticShardedPass``, replays the pass as a CUDA graph captured at the
    first call of each batch size (one at a time: a new one frees the old
    graph and buffers), and returns a fresh tensor of the roots.  With
    ``batch_axis`` one graph runs every local batch rank's columns through
    the same static pass, one after the other, and gathers the roots.  It
    needs a CUDA device (``ValueError`` otherwise).  The default stays
    eager.
    """
    plan = _Plan(lowered, mesh, graph_axis, dtype, local_reuse, interleave, layout)
    if jit:
        require_cuda(mesh.device, "make_graph_sharded_evaluator")

    def leaf_input(leaf_values) -> torch.Tensor:
        leaf_values = torch.as_tensor(leaf_values, device=mesh.device).to(plan.dtype)
        return leaf_values[:, None] if leaf_values.dim() == 1 else leaf_values

    def evaluate(leaf_values) -> torch.Tensor:
        leaf_values = leaf_input(leaf_values)
        if batch_axis is None:
            return plan.eval(leaf_values)
        parts = [plan.eval(leaf_values[:, cols])
                 for cols in _rank_columns(leaf_values.shape[1], mesh, batch_axis)]
        return mesh.all_gather(batch_axis, parts, dim=1)

    if not jit:
        return _Sharded(evaluate, plan)

    def prepare(leaf_values):
        if batch_axis is None:
            sp = plan.static_pass(leaf_values.shape[1])
            return [sp.leaves], sp.run
        cols = _rank_columns(leaf_values.shape[1], mesh, batch_axis)
        sp = plan.static_pass(leaf_values.shape[1] // mesh.shape[batch_axis])
        static = torch.empty_like(leaf_values)

        def body() -> torch.Tensor:
            parts = []
            for c in cols:
                sp.leaves.copy_(static[:, c])
                parts.append(sp.run())
            return mesh.all_gather(batch_axis, parts, dim=1)

        return [static], body

    captured = Captured(prepare)

    def evaluate_jit(leaf_values) -> torch.Tensor:
        leaf_values = leaf_input(leaf_values)
        if leaf_values.shape[0] != plan.nl_input:
            raise ValueError(f"jit=True takes all {plan.nl_input} leaf rows, got "
                             f"{leaf_values.shape[0]}")
        return captured(leaf_values)

    return _Sharded(evaluate_jit, plan)


def make_graph_sharded_mc_step(lowered: LoweredGraph, tables, mesh: Mesh, *,
                               beta: float, kF: float, lam: float,
                               graph_axis: str = GRAPH_AXIS,
                               batch_axis: str = BATCH_AXIS,
                               dtype=None, local_reuse: bool = True,
                               interleave: Optional[bool] = None,
                               layout: str = "flat",
                               interaction_convention: str = "lambda_power",
                               jit: bool = False):
    """The BASELINE-config-5 production shape: one Monte-Carlo estimation
    step with the graph memory-partitioned over ``graph_axis`` and the
    samples data-parallel over ``batch_axis``.

    Returns ``step(seed, batch_per_device, iters) -> means[R]`` with the
    planner's footprint as ``.stats``.  For each batch rank ``b`` held here
    and iteration ``i``: a ``torch.Generator`` on the mesh's device seeded
    with ``sharding.rank_seed(seed, b, i)`` draws ``varK`` ``[3, max_loop,
    batch_per_device]`` normal, then ``varT`` ``[num_tau,
    batch_per_device]`` uniform times ``beta`` (the same samples on every
    graph rank, as the slot partition requires); the leaf phase
    (``ops.leaf_eval``) evaluates them, each graph rank takes its leaf
    rows, the halo-exchanged levels run, and the roots' sums over the
    samples accumulate.  Each batch rank's sums over ``iters *
    batch_per_device`` are its means, and ``mean`` reduces them over the
    batch axis.

    ``jit=True`` is the counterpart of the JAX step's ``fori_loop`` under
    one ``jax.jit``: one iteration over every batch and graph rank held
    here (the draws into static ``varK`` / ``varT`` from one generator a
    batch rank, registered with the graph; the leaf phase into a
    ``StaticShardedPass``; its pass; the roots' sums into a static
    accumulator a batch rank) is captured as one CUDA graph, and a step
    replays it ``iters`` times, seeding each batch rank's generator with
    ``rank_seed(seed, b, i)`` before replay ``i``: the eager step's draws
    and means.  The graph is held for one ``batch_per_device`` at a time (a
    new one captures again; the JAX package caches 8 shapes).  It needs a
    CUDA device (``ValueError`` otherwise).
    """
    from ..ops.leaf_eval import make_leaf_evaluator

    plan = _Plan(lowered, mesh, graph_axis, dtype, local_reuse, interleave, layout)
    if jit:
        require_cuda(mesh.device, "make_graph_sharded_mc_step")
    leaf_fn = make_leaf_evaluator(tables, beta=beta, kF=kF, lam=lam, device=mesh.device,
                                  dtype=plan.dtype,
                                  interaction_convention=interaction_convention)
    max_loop = tables.loop_basis.shape[1]
    num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
    n_roots = len(lowered.root_slots)
    batch_ranks = list(mesh.local_ranks(batch_axis))

    def step(seed: int, batch_per_device: int, iters: int) -> torch.Tensor:
        means = []
        for b in batch_ranks:
            acc = torch.zeros(n_roots, dtype=plan.dtype, device=mesh.device)
            for i in range(iters):
                gen = torch.Generator(device=mesh.device)
                gen.manual_seed(rank_seed(seed, b, i))
                vk = torch.randn((3, max_loop, batch_per_device), generator=gen,
                                 dtype=plan.dtype, device=mesh.device)
                vt = torch.rand((num_tau, batch_per_device), generator=gen,
                                dtype=plan.dtype, device=mesh.device) * beta
                full = plan.full(batch_per_device)
                leaf_fn(vk, vt, out=full[:plan.nl_input])
                acc = acc + plan.device_eval(plan.split(full)).sum(dim=1)
            means.append(acc / (iters * batch_per_device))
        return mesh.mean(batch_axis, means)

    def build(batch_per_device: int) -> SeededGraph:
        dev = mesh.device
        gens = [torch.Generator(device=dev) for _ in batch_ranks]
        vk = torch.empty((3, max_loop, batch_per_device), dtype=plan.dtype, device=dev)
        vt = torch.empty((num_tau, batch_per_device), dtype=plan.dtype, device=dev)
        sp = plan.static_pass(batch_per_device)
        accs = torch.zeros((len(batch_ranks), n_roots), dtype=plan.dtype, device=dev)

        def body() -> torch.Tensor:
            # normal_ and uniform_ are what torch.randn and torch.rand run
            for gen, acc in zip(gens, accs):
                vk.normal_(generator=gen)
                vt.uniform_(generator=gen).mul_(beta)
                leaf_fn(vk, vt, out=sp.leaves)
                acc += sp.run().sum(dim=1)
            return accs

        return SeededGraph(body, gens)

    graph_of = one_shape(build)

    def step_jit(seed: int, batch_per_device: int, iters: int) -> torch.Tensor:
        graph = graph_of(batch_per_device)
        graph.out.zero_()
        for i in range(iters):
            graph.replay([rank_seed(seed, b, i) for b in batch_ranks])
        return mesh.mean(batch_axis, [acc / (iters * batch_per_device) for acc in graph.out])

    fn = step_jit if jit else step
    fn.stats = plan.stats
    return fn
