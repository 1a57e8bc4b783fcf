"""The gather-reduce kernel: wrappers, the level tables and plain versions.

For a bucket ``(idx [n_op, arity, count], fac [arity, count], start)`` the
kernel computes, in place on the weight buffer ``w``,

    w[start + c, :] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], :]

which is the ``SumBucket`` primitive (``n_op == 1``, the function of the
Pallas kernel ``feynmandiagram_tpu/ops/kernels.py::bucket_gather_reduce``)
and the ``FusedBucket`` primitive of ``sum_mode='fused'`` (``n_op <= 4``);
a ``ProdPlan`` or ``PowerPlan`` of up to 4 operands is a bucket of one term
(``ops/evaluator.py::plan_bucket``).

A level's buckets run in one launch, from tables that ``pack_level`` packs
once and uploads: no bucket of a level reads a row that another one writes
(``ops/evaluator.py::check_lowered``), so they may run at once.  Given
``src``, a level reads its rows from that buffer instead of ``w`` (the halo
of a graph-sharded level, ``parallel/graph_shard.py``) and writes them to
``w``.  Every launch on the card goes through ``levels_gather_reduce``: one
C call that launches a ``LevelRun``, a run of levels prepared once for a
batch size (``plan_run``), each level's launch in order, except that each
*stretch* of two or more consecutive thin levels is one launch of a second
kernel, the *column run* (``pack_column_run``), whose blocks each carry a
slice of the batch's columns through every level of the stretch
(``column_run_gather_reduce_plain`` is its plain version).
``level_gather_reduce`` checks one level's tables and launches the run of
that level alone; ``bucket_gather_reduce`` packs one bucket as a level and
launches it so.  On a CUDA tensor the wrappers launch the hand-written CUDA
kernels in ``csrc/bucket_gather_reduce.cu``; on a CPU tensor they run their
plain PyTorch versions.  Nothing falls back: a CUDA build or launch failure
raises.  The kernels are built at first use (``ops/build.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from ..utils.profiling import launched_run, scope

MAX_N_OP = 4
_OFF = contextlib.nullcontext()
STORAGE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)

# (storage dtype, accumulation dtype) pairs the CUDA kernel is instantiated
# for, and the type codes its C entry point takes
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
CUDA_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.float64, torch.float64),
                    (torch.float32, torch.float64), (torch.bfloat16, torch.float32))


# output rows of a row tile (csrc/bucket_gather_reduce.cu), the int32 columns
# of a record of the tile table on the device, and those of a bucket's
# descriptor on the host
TILE_ROWS = 8
TILE_FIELDS = ("dst", "rows", "arity", "n_op", "idx", "fac", "count", "span")
DESC_FIELDS = ("start", "count", "arity", "n_op", "idx_off", "fac_off", "first_tile")
# How a launch is cut into blocks.  A piece is what a warp loads at once, 32
# lanes of 16 bytes; an item is a row tile by ITEM_PIECES pieces; a record of
# the tile table is a row tile and the pieces of an item that one block
# takes, one after the other.  A block first waits for its record and its
# indices, so a row tile of few terms gets wide records, which share that
# wait; a row tile of many terms gets a record per piece, so that its long
# chains of gathers spread over many blocks (``_record_width``).  Of the
# ``RECORD_WIDTHS`` a launch takes the widest that still leaves it
# TARGET_BLOCKS blocks.  Items run column group by column group; a group is
# as wide as keeps the rows that the launch touches inside L2_GROUP_BYTES, so
# that a row gathered by several buckets is fetched from memory once.  The
# arity limits of ``_record_width``, TARGET_BLOCKS and L2_GROUP_BYTES were
# set by a sweep on the card; a sweep patches these constants.
PIECE_BYTES = 32 * 16
ITEM_PIECES = 8
RECORD_WIDTHS = (4, 2, 1)
TARGET_BLOCKS = 528
L2_GROUP_BYTES = 24 * 2 ** 20
# The column run (``pack_column_run``).  A level is thin where its distinct
# rows read and rows written, times the batch and the element size, come to
# under THIN_BYTES, and none of its rows gathers more than RUN_MAX_GATHERS
# rows: it then takes about a launch's fixed cost, whatever its size, and a
# block of a column run, which takes a row's gathers one after the other,
# waits for no long chain.  A stretch of two or more thin levels of a run is
# one launch of blocks of RUN_THREADS threads, each block owning the same
# columns of every row, 16 bytes a thread, as many as leave about RUN_BLOCKS
# blocks across the batch (``run_lanes``); a row's record holds its first
# RUN_GATHERS gathers.  THIN_BYTES, RUN_MAX_GATHERS, RUN_BLOCKS and
# RUN_THREADS were set by a sweep on the card (PERF.md §6 has the numbers).
THIN_BYTES = 32 * 2 ** 20
RUN_MAX_GATHERS = 8
RUN_BLOCKS = 256
RUN_THREADS = 256
RUN_GATHERS = 4


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fd_levels_gather_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` where ``device`` (with its index) is not
    the current device, else a context that does nothing: a launch on
    the current device needs no guard."""
    if torch.cuda.current_device() == device.index:
        return _OFF
    return torch.cuda.device(device)


def cuda_type_codes(w_dtype: torch.dtype, fac_dtype: torch.dtype,
                    acc_dtype: Optional[torch.dtype]) -> Tuple[int, int]:
    """The CUDA kernel's (storage, accumulator) type codes for these dtypes.

    The accumulation type is ``acc_dtype or w_dtype``; the pair must be one
    of ``CUDA_DTYPE_PAIRS``, and ``fac`` must be in the accumulation type.
    Raises ``ValueError`` otherwise."""
    acc = acc_dtype or w_dtype
    if (w_dtype, acc) not in CUDA_DTYPE_PAIRS:
        raise ValueError(f"the CUDA kernel stores {w_dtype} with accumulation {acc}: "
                         f"not one of its pairs {CUDA_DTYPE_PAIRS}")
    if fac_dtype != acc:
        raise ValueError(f"fac dtype {fac_dtype} differs from the accumulation dtype {acc}")
    return _TYPE_CODE[w_dtype], _TYPE_CODE[acc]


def _check_w(w: torch.Tensor) -> None:
    if w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D tensor, got shape {tuple(w.shape)}")
    if w.dtype not in STORAGE_DTYPES:
        raise ValueError(f"w must be one of {STORAGE_DTYPES}, got {w.dtype}")


def _check(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor, start: int) -> None:
    _check_w(w)
    if idx.dim() != 3 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int32 [n_op, arity, count] tensor")
    n_op, arity, count = idx.shape
    if not 1 <= n_op <= MAX_N_OP:
        raise ValueError(f"n_op must be in 1..{MAX_N_OP}, got {n_op}")
    if arity < 1 or count < 1:
        raise ValueError(f"empty bucket: arity {arity}, count {count}")
    if tuple(fac.shape) != (arity, count) or not fac.is_contiguous():
        raise ValueError(f"fac must be a contiguous [{arity}, {count}] tensor, "
                         f"got {tuple(fac.shape)}")
    if not (idx.device == w.device and fac.device == w.device):
        raise ValueError("w, idx and fac must lie on one device")
    if not 0 <= start <= w.shape[0] - count:
        raise ValueError(f"rows {start}..{start + count} outside w's {w.shape[0]} rows")


def bucket_gather_reduce_plain(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor,
                               start: int, *, compensated: bool = False,
                               acc_dtype: Optional[torch.dtype] = None,
                               chunk_rows: Optional[int] = None,
                               src: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of the kernel, on any device, in place on ``w``.

    Term order follows the JAX evaluator: ``(w[idx[0]] * fac) * w[idx[1]] *
    ...``, then the terms are added in order ``a = 0, 1, ...``
    (Kahan-compensated if asked), as the kernel adds them, so a column's
    value does not depend on the other columns (``torch.sum`` over the
    terms chose its order by the batch's width on the CPU).  With ``src``
    the terms read rows of ``src`` instead of ``w``.
    ``chunk_rows`` bounds the temporaries to ``n_op * arity * chunk_rows``
    gathered rows."""
    _check(w, idx, fac, start)
    rows = w if src is None else src
    n_op, arity, count = idx.shape
    a = acc_dtype or w.dtype
    step = chunk_rows or count
    for c0 in range(0, count, step):
        c1 = min(c0 + step, count)
        ix = idx[:, :, c0:c1]
        block = torch.index_select(rows, 0, ix[0].reshape(-1)).view(arity, c1 - c0, -1)
        block = block.to(a) * fac[:, c0:c1, None].to(a)
        for k in range(1, n_op):
            block = block * torch.index_select(rows, 0, ix[k].reshape(-1)).view(
                arity, c1 - c0, -1).to(a)
        s = block[0]
        if compensated:
            comp = torch.zeros_like(s)
            for i in range(1, arity):
                y = block[i] - comp
                t = s + y
                comp = (t - s) - y
                s = t
        else:
            for i in range(1, arity):
                s = s + block[i]
        w[start + c0:start + c1] = s.to(w.dtype)


def bucket_gather_reduce(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor,
                         start: int, *, compensated: bool = False,
                         acc_dtype: Optional[torch.dtype] = None,
                         chunk_rows: Optional[int] = None) -> None:
    """Write ``sum_a fac[a, c] * prod_k w[idx[k, a, c]]`` into rows
    ``start .. start + count`` of ``w``.

    A CUDA ``w`` packs the bucket as a level of one bucket (``pack_level``,
    through the host) and launches it on the current stream
    (``level_gather_reduce``): the kernel reads ``w`` in its storage type,
    computes in ``acc_dtype or w.dtype`` (a pair of ``CUDA_DTYPE_PAIRS``,
    with ``fac`` in the accumulation type) and rounds once to ``w.dtype`` on
    store; ``chunk_rows`` does not apply.  A CPU ``w`` runs
    ``bucket_gather_reduce_plain``.  Any other device raises.
    """
    if w.device.type == "cpu":
        bucket_gather_reduce_plain(w, idx, fac, start, compensated=compensated,
                                   acc_dtype=acc_dtype, chunk_rows=chunk_rows)
        return
    if w.device.type != "cuda":
        raise ValueError(f"bucket_gather_reduce runs on cuda or cpu tensors, "
                         f"not {w.device.type}")
    _check(w, idx, fac, start)
    cuda_type_codes(w.dtype, fac.dtype, acc_dtype)
    level_gather_reduce(w, pack_level([(idx.cpu(), fac.cpu(), start)], w.device, fac.dtype),
                        compensated=compensated, acc_dtype=acc_dtype)


def _items_across(w: torch.Tensor) -> int:
    return -(-w.shape[1] * w.element_size() // (ITEM_PIECES * PIECE_BYTES))


def _record_width(arity: int, widest: int) -> int:
    """Pieces of an item that one block takes of a row tile of ``arity``
    terms, where the launch's widest records have ``widest``."""
    if arity < 4:
        return widest
    return min(widest, 2) if arity < 16 else 1


def _group_cols(w: torch.Tensor, rows_touched: int) -> int:
    """The width of a column group in columns of ``w``, for a launch that
    touches ``rows_touched`` rows (the kernel rounds it to whole items)."""
    return max(L2_GROUP_BYTES // (rows_touched * w.element_size()), 1)


# ---------------------------------------------------------------------------
# one launch per level

Bucket = Tuple[np.ndarray, np.ndarray, int]   # idx [n_op, arity, count], fac, start


@dataclass
class LevelTables:
    """The buckets of one level, packed for one launch.

    ``idx`` (int32) and ``fac`` (the accumulation type) are the buckets'
    tables laid end to end, each flattened as it is (``[n_op, arity, count]``
    and ``[arity, count]``, ``count`` fastest).  ``records[widest]`` is the
    tile table for records of at most ``widest`` pieces, a row of
    ``TILE_FIELDS`` per record: the first of the row tile's rows of ``w`` and
    how many, the bucket's shape, where the tile's first output stands in the
    pools, and ``span``, the record's first piece of the item (low 16 bits)
    and its number of pieces.  Pools and tile tables lie on the device.
    ``desc`` is the host's table, a row of ``DESC_FIELDS`` per bucket: its
    rows ``start .. start + count`` of ``w``, its shape, its offsets into the
    pools and the first of its row tiles in the tiles' order; the plain
    version reads the buckets back through it.  ``row_end`` is one past the
    last row of ``w`` that the level writes, ``max_index`` the largest row
    that it reads, ``rows_touched`` the rows it reads (distinct) and
    writes; ``column`` the level's rows as a column run reads them
    (``ColumnRows``), and ``column_runs`` the column runs packed so far
    that start at this level (``column_run_of``), which live as long as the
    level's tables, as a captured graph that launches them needs."""
    idx: torch.Tensor
    fac: torch.Tensor
    records: Dict[int, torch.Tensor]
    desc: np.ndarray
    row_end: int
    max_index: int
    rows_touched: int
    column: "ColumnRows"
    column_runs: Dict[tuple, "ColumnRun"] = field(default_factory=dict)

    def records_for(self, w: torch.Tensor) -> torch.Tensor:
        """The tile table for a launch on ``w``: the widest records that
        leave TARGET_BLOCKS blocks."""
        across = _items_across(w)
        for widest in RECORD_WIDTHS:
            table = self.records[widest]
            if table.shape[0] * across >= TARGET_BLOCKS:
                break
        return table


def _tile_records(desc: np.ndarray, widest: int) -> np.ndarray:
    """The tile table of ``desc`` for records of at most ``widest`` pieces,
    row tiles in the order of their ``first_tile``."""
    out = []
    for start, count, arity, n_op, i_off, f_off, _ in desc[np.argsort(desc[:, 6])].tolist():
        width = _record_width(arity, widest)
        c0 = np.repeat(TILE_ROWS * np.arange(-(-count // TILE_ROWS)), ITEM_PIECES // width)
        rec = np.zeros((len(c0), len(TILE_FIELDS)), np.int32)
        rec[:, 0], rec[:, 1] = start + c0, np.minimum(TILE_ROWS, count - c0)
        rec[:, 2:4] = arity, n_op
        rec[:, 4], rec[:, 5], rec[:, 6] = i_off + c0, f_off + c0, count
        rec[:, 7] = (np.arange(len(c0)) % (ITEM_PIECES // width) * width) | (width << 16)
        out.append(rec)
    return np.concatenate(out)


@dataclass
class ColumnRows:
    """A level's output rows as a column run reads them, on the host, in the
    order of the level's row tiles.  A row is its list of gathers, term
    ``a``'s operands ``k = 0 .. n_op - 1`` in turn, each the row of ``w`` it
    reads, bit 31 set on a term's first operand, which carries the term's
    factor.  ``rows`` is int32 ``[n, 8]``: the row of ``w`` written, its
    gathers, where those past the first ``RUN_GATHERS`` begin in the extra
    arrays, 0, then its first ``RUN_GATHERS`` gathers (0 where it has
    fewer); ``fac_at`` int64 ``[n, RUN_GATHERS]`` the positions in the
    level's factor pool of those gathers' factors (a term's, on each of its
    operands); ``extra_idx`` (int32) and ``extra_fac_at`` (int64) the same
    for the gathers past the first ``RUN_GATHERS``, row after row."""
    rows: np.ndarray
    fac_at: np.ndarray
    extra_idx: np.ndarray
    extra_fac_at: np.ndarray


def _column_rows(desc: np.ndarray, idx_pool: np.ndarray) -> ColumnRows:
    rows, fac_at, extra_idx, extra_fac_at, n_extra = [], [], [], [], 0
    for start, count, arity, n_op, i_off, f_off, _ in desc[np.argsort(desc[:, 6])].tolist():
        n_g = n_op * arity
        c = np.arange(count)[:, None]
        a, k = np.divmod(np.arange(n_g), n_op)         # gather a * n_op + k
        g = idx_pool[i_off + (k * arity + a) * count + c].astype(np.uint32)
        g |= (k == 0).astype(np.uint32) << 31
        g = g.view(np.int32)
        f = f_off + a * count + c
        head = min(n_g, RUN_GATHERS)
        rec = np.zeros((count, 8), np.int32)
        rec[:, 0] = start + c[:, 0]
        rec[:, 1] = n_g
        rec[:, 4:4 + head] = g[:, :head]
        at = np.zeros((count, RUN_GATHERS), np.int64)
        at[:, :head] = f[:, :head]
        if n_g > RUN_GATHERS:
            rec[:, 2] = n_extra + (n_g - RUN_GATHERS) * c[:, 0]
            extra_idx.append(g[:, RUN_GATHERS:].reshape(-1))
            extra_fac_at.append(f[:, RUN_GATHERS:].reshape(-1))
            n_extra += count * (n_g - RUN_GATHERS)
        rows.append(rec)
        fac_at.append(at)
    return ColumnRows(np.concatenate(rows), np.concatenate(fac_at),
                      np.concatenate(extra_idx) if extra_idx else np.zeros(0, np.int32),
                      np.concatenate(extra_fac_at) if extra_fac_at else np.zeros(0, np.int64))


def pack_level(buckets: Sequence[Bucket], device, fac_dtype: torch.dtype) -> LevelTables:
    """Pack the buckets ``(idx, fac, start)`` of one level and upload them.

    Descriptors keep the buckets' order; row tiles are ordered by falling
    ``n_op * arity`` (stable), so that the launch starts its longest items
    first.  Raises on an empty list, an empty bucket, a negative index or
    ``n_op`` outside ``1..MAX_N_OP``."""
    if not buckets:
        raise ValueError("a level without buckets has no tables")
    desc = np.zeros((len(buckets), len(DESC_FIELDS)), np.int64)
    idx_parts, fac_parts, idx_off, fac_off = [], [], 0, 0
    for b, (idx, fac, start) in enumerate(buckets):
        idx = np.ascontiguousarray(idx, np.int32)
        fac = np.ascontiguousarray(fac)
        if idx.ndim != 3 or fac.shape != idx.shape[1:]:
            raise ValueError(f"bucket {b}: idx {idx.shape} and fac {fac.shape} do not match "
                             f"[n_op, arity, count] and [arity, count]")
        n_op, arity, count = idx.shape
        if not 1 <= n_op <= MAX_N_OP or arity < 1 or count < 1 or start < 0:
            raise ValueError(f"bucket {b}: n_op {n_op} (1..{MAX_N_OP}), arity {arity}, "
                             f"count {count}, start {start}")
        desc[b, :6] = (start, count, arity, n_op, idx_off, fac_off)
        idx_parts.append(idx.reshape(-1))
        fac_parts.append(fac.reshape(-1))
        idx_off += idx.size
        fac_off += fac.size
    row_end = int((desc[:, 0] + desc[:, 1]).max())
    if max(idx_off, row_end) >= 2 ** 31:
        raise ValueError(f"the level's index pool ({idx_off} entries) or rows (to {row_end}) "
                         f"are over int32")
    order = np.argsort(-(desc[:, 3] * desc[:, 2]), kind="stable")
    n_tiles = -(-desc[:, 1] // TILE_ROWS)
    desc[order, 6] = np.cumsum(n_tiles[order]) - n_tiles[order]
    idx_pool = np.concatenate(idx_parts)
    if idx_pool.min() < 0:
        raise ValueError(f"the level reads row {int(idx_pool.min())}")
    return LevelTables(
        idx=torch.as_tensor(idx_pool, device=device),
        fac=torch.as_tensor(np.concatenate(fac_parts), device=device).to(fac_dtype),
        records={widest: torch.as_tensor(_tile_records(desc, widest), device=device)
                 for widest in RECORD_WIDTHS},
        desc=desc, row_end=row_end, max_index=int(idx_pool.max()),
        rows_touched=len(np.unique(idx_pool)) + int(desc[:, 1].sum()),
        column=_column_rows(desc, idx_pool))


def unpack_level(tables: LevelTables) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
    """The buckets ``(idx [n_op, arity, count], fac [arity, count], start)``
    of packed tables, as views of the pools, in the descriptors' order."""
    out = []
    for start, count, arity, n_op, idx_off, fac_off, _ in tables.desc.tolist():
        idx = tables.idx[idx_off:idx_off + n_op * arity * count].view(n_op, arity, count)
        fac = tables.fac[fac_off:fac_off + arity * count].view(arity, count)
        out.append((idx, fac, start))
    return out


def _check_level(w: torch.Tensor, tables: LevelTables, src: Optional[torch.Tensor]) -> None:
    """Raise unless ``tables`` fit ``w`` and the buffer they read, ``src``
    or ``w``: one device, one dtype and batch, the written rows inside ``w``
    and every index inside the read buffer (``max_index``, from the host)."""
    _check_w(w)
    rows = w
    if src is not None:
        _check_w(src)
        if (src.device, src.dtype, src.shape[1]) != (w.device, w.dtype, w.shape[1]):
            raise ValueError(f"src ({src.device}, {src.dtype}, batch {src.shape[1]}) differs "
                             f"from w ({w.device}, {w.dtype}, batch {w.shape[1]})")
        rows = src
    _check_fits(tables, w.shape[0], rows.shape[0])


def _check_fits(tables: LevelTables, rows: int, read_rows: int) -> None:
    if tables.row_end > rows:
        raise ValueError(f"the level writes rows up to {tables.row_end} of w's {rows}")
    if tables.max_index >= read_rows:
        raise ValueError(f"the level reads row {tables.max_index} of a buffer of "
                         f"{read_rows} rows")


def level_gather_reduce_plain(w: torch.Tensor, tables: LevelTables, *,
                              compensated: bool = False,
                              acc_dtype: Optional[torch.dtype] = None,
                              chunk_rows: Optional[int] = None,
                              src: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of the level kernel, on any device, in place:
    ``bucket_gather_reduce_plain`` over the buckets read back from the
    packed tables, reading rows of ``src`` where it is given."""
    _check_level(w, tables, src)
    for idx, fac, start in unpack_level(tables):
        bucket_gather_reduce_plain(w, idx, fac, start, compensated=compensated,
                                   acc_dtype=acc_dtype, chunk_rows=chunk_rows, src=src)


def level_gather_reduce(w: torch.Tensor, tables: LevelTables, *, compensated: bool = False,
                        acc_dtype: Optional[torch.dtype] = None,
                        chunk_rows: Optional[int] = None,
                        src: Optional[torch.Tensor] = None) -> None:
    """Run every bucket of ``tables`` on ``w``, in place.

    The indices are rows of ``src`` where it is given (a buffer of ``w``'s
    device, dtype and batch), else of ``w``; the outputs go to ``w``.
    Every call checks that the level's rows lie inside ``w`` and its indices
    inside the buffer it reads.  A CUDA ``w`` launches the kernel once, on
    the current stream, with the types and rounding of
    ``bucket_gather_reduce``: a ``LevelRun`` of this level alone, through
    ``levels_gather_reduce``; reading ``w`` itself, the caller guarantees
    that no bucket reads a destination row of the level
    (``check_lowered``).  A CPU ``w`` runs ``level_gather_reduce_plain``.
    Any other device raises.  ``level_gather_reduce.launches`` counts every
    launch of the kernel, whichever wrapper issued it, replays of a captured
    one included; ``level_gather_reduce.symbol`` is the kernel's name."""
    if w.device.type == "cpu":
        level_gather_reduce_plain(w, tables, compensated=compensated, acc_dtype=acc_dtype,
                                  chunk_rows=chunk_rows, src=src)
        return
    if w.device.type != "cuda":
        raise ValueError(f"level_gather_reduce runs on cuda or cpu tensors, "
                         f"not {w.device.type}")
    _check_level(w, tables, src)
    _check_on(w.device, tables)
    run = LevelRun(w.shape[1], np.array([level_row(w, tables) + (0, 0, 0)], np.int64), ("",),
                   cuda_type_codes(w.dtype, tables.fac.dtype, acc_dtype), compensated)
    with torch.cuda.device(w.device):
        levels_gather_reduce(w, run, torch.cuda.current_stream(w.device).cuda_stream, src=src)


level_gather_reduce.launches = 0
level_gather_reduce.symbol = "gather_reduce_kernel"


def _check_on(device: torch.device, tables: LevelTables) -> None:
    if not all(t.device == device for t in (tables.idx, tables.fac, *tables.records.values())):
        raise ValueError(f"w and the level tables must lie on one device, {device}")


def check_tables(tables: LevelTables, rows: int, device: torch.device) -> None:
    """Raise unless a level's launch on a buffer of ``rows`` rows on
    ``device`` fits ``tables``: the rows it writes and reads inside the
    buffer, and its tables on ``device``."""
    _check_fits(tables, rows, rows)
    _check_on(device, tables)


def level_row(w: torch.Tensor, tables: LevelTables) -> Tuple[int, int, int, int, int]:
    """What a level's launch on ``w`` takes of its tables, in the order of a
    row of ``LevelRun.table`` (``RUN_FIELDS``): the pools' and the tile
    table's addresses (``records_for``), its records and the column group's
    width (``_group_cols``).  Only ``w``'s batch and element size count."""
    records = tables.records_for(w)
    return (tables.idx.data_ptr(), tables.fac.data_ptr(), records.data_ptr(),
            records.shape[0], _group_cols(w, tables.rows_touched))


# ---------------------------------------------------------------------------
# a stretch of thin levels in one launch: the column run


@dataclass
class ColumnRun:
    """A stretch of consecutive levels packed for one column-run launch
    (``pack_column_run``): on the device, ``level_rows`` (int32, level
    ``l``'s rows are ``level_rows[l] .. level_rows[l + 1]``), ``rows`` (int32
    ``[n, 8]``, ``ColumnRows.rows`` laid end to end, the extra offsets
    shifted), ``row_fac`` (``[n, RUN_GATHERS]`` in the accumulation type),
    ``extra_idx`` and ``extra_fac`` (one element at least); ``host_rows`` and
    ``host_extra_idx`` are the host's copies of ``rows`` and ``extra_idx``."""
    level_rows: torch.Tensor
    rows: torch.Tensor
    row_fac: torch.Tensor
    extra_idx: torch.Tensor
    extra_fac: torch.Tensor
    host_rows: np.ndarray
    host_extra_idx: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.level_rows) - 1


def pack_column_run(levels: Sequence[LevelTables]) -> ColumnRun:
    """Pack the levels ``levels``, consecutive levels of a pass, for one
    column-run launch, on their tables' device: each level's
    ``ColumnRows`` in turn, and the factors copied out of its factor pool."""
    device = levels[0].fac.device
    rows, extra_idx, extra_fac, n_extra = [], [], [], 0
    for t in levels:
        r = t.column.rows.copy()
        r[r[:, 1] > RUN_GATHERS, 2] += n_extra
        rows.append(r)
        extra_idx.append(t.column.extra_idx)
        n_extra += len(t.column.extra_idx)
    counts = [len(r) for r in rows]
    rows, extra_idx = np.concatenate(rows), np.concatenate(extra_idx + [np.zeros(1, np.int32)])

    def facs(at) -> torch.Tensor:
        return torch.cat([t.fac[torch.as_tensor(getattr(t.column, at), device=device).view(-1)]
                          for t in levels])

    return ColumnRun(
        level_rows=torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
                                   device=device),
        rows=torch.as_tensor(rows, device=device), row_fac=facs("fac_at").view(-1, RUN_GATHERS),
        extra_idx=torch.as_tensor(extra_idx, device=device),
        extra_fac=torch.cat([facs("extra_fac_at"), levels[0].fac[:1]]),
        host_rows=rows, host_extra_idx=extra_idx)


def column_run_of(levels: Sequence[LevelTables]) -> ColumnRun:
    """The column run of ``levels``, packed once (``pack_column_run``) and
    kept with the first level's tables."""
    key = tuple(id(t) for t in levels)
    run = levels[0].column_runs.get(key)
    if run is None:
        run = levels[0].column_runs[key] = pack_column_run(levels)
    return run


def column_run_gather_reduce_plain(w: torch.Tensor, run: ColumnRun, *,
                                   compensated: bool = False,
                                   acc_dtype: Optional[torch.dtype] = None) -> None:
    """Plain PyTorch version of a column run, on any device, in place on
    ``w``: level after level, each row's gathers taken in order as the
    kernel takes them, a term's first operand times its factor, then times
    each further operand, the terms added in order (Kahan-compensated if
    asked) in ``acc_dtype or w.dtype``, rounded once to ``w.dtype``."""
    a = acc_dtype or w.dtype
    dev = w.device
    n = len(run.host_rows)
    all_fac = torch.cat([run.row_fac.reshape(-1), run.extra_fac]).to(dev)
    bounds = run.level_rows.tolist()
    for r0, r1 in zip(bounds, bounds[1:]):
        rec = run.host_rows[r0:r1]
        n_g = rec[:, 1]
        width = int(n_g.max())
        gi = np.zeros((r1 - r0, width), np.int32)
        fi = np.zeros((r1 - r0, width), np.int64)
        head = min(width, RUN_GATHERS)
        gi[:, :head] = rec[:, 4:4 + head]
        fi[:, :head] = RUN_GATHERS * np.arange(r0, r1)[:, None] + np.arange(head)
        for j in range(RUN_GATHERS, width):
            more = n_g > j
            at = rec[more, 2] + j - RUN_GATHERS
            gi[more, j] = run.host_extra_idx[at]
            fi[more, j] = RUN_GATHERS * n + at
        valid = torch.as_tensor(np.arange(width) < n_g[:, None], device=dev)
        starts = torch.as_tensor(gi < 0, device=dev)
        rows_read = torch.as_tensor(gi.astype(np.int64) & 0x7fffffff, device=dev)
        fac = all_fac[torch.as_tensor(fi, device=dev)]
        shape = (r1 - r0, w.shape[1])
        term = torch.zeros(shape, dtype=a, device=dev)
        total = torch.zeros_like(term)
        comp = torch.zeros_like(term)
        open_ = torch.zeros(r1 - r0, dtype=torch.bool, device=dev)
        added = torch.zeros_like(open_)

        def close(mask):
            nonlocal total, comp, added
            first, later = (mask & ~added)[:, None], (mask & added)[:, None]
            if compensated:
                y = term - comp
                t = total + y
                step, c = t, (t - total) - y
            else:
                step, c = total + term, comp
            total = torch.where(first, term, torch.where(later, step, total))
            comp = torch.where(first, torch.zeros_like(comp), torch.where(later, c, comp))
            added = added | mask

        for j in range(width):
            v = w[rows_read[:, j]].to(a)
            st = starts[:, j] & valid[:, j]
            close(st & open_)
            new = torch.where(st[:, None], v * fac[:, j, None], term * v)
            term = torch.where(valid[:, j, None], new, term)
            open_ = open_ | valid[:, j]
        close(open_)
        w[torch.as_tensor(rec[:, 0].astype(np.int64), device=dev)] = total.to(w.dtype)


class RunKernel:
    """A kernel that only a run of levels launches (``levels_gather_reduce``),
    as a launch wrapper for ``utils.profiling``: its ``symbol`` as the
    device's records name it, its ``launches``, and the ``levels`` of a
    pass that they computed, replays of a captured one included."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self.levels = 0


column_run_gather_reduce = RunKernel("column_run_gather_reduce_kernel")


def is_thin(tables: LevelTables, batch: int, element_size: int) -> bool:
    """Whether a level is thin at this batch: its distinct rows read and
    rows written, times ``batch`` and ``element_size``, under
    ``THIN_BYTES``, and none of its rows over ``RUN_MAX_GATHERS`` gathers."""
    return (tables.rows_touched * batch * element_size < THIN_BYTES
            and int(tables.column.rows[:, 1].max()) <= RUN_MAX_GATHERS)


def stretches(thin: Sequence[bool]) -> List[Tuple[int, int]]:
    """The stretches of a run whose levels are ``thin`` or not: each
    ``(first, end)`` of two or more consecutive thin levels, as long as it
    goes."""
    out, i = [], 0
    while i < len(thin):
        j = i
        while j < len(thin) and thin[j]:
            j += 1
        if j - i >= 2:
            out.append((i, j))
        i = max(j, i + 1)
    return out


# ---------------------------------------------------------------------------
# a run of levels from one C call

RUN_FIELDS = ("idx", "fac", "tiles", "n_records", "group_cols", "levels", "extra_idx",
              "extra_fac")


@dataclass
class LevelRun:
    """The launches of a run of levels at one batch size, prepared once
    (``plan_run``): ``table`` has a row of ``RUN_FIELDS`` a launch, in level
    order, on the host: a level's launch (``level_row``, then ``levels`` 0)
    or a column run's over ``levels`` levels (``column_run_row``);
    ``paths`` the launches' scope paths (``gL05/fb8`` for a level,
    ``gL04-gL298/run`` for a column run, empty for a level launched alone,
    which the scopes open around it name), which name them in a capture's
    manifest and in errors; ``codes`` the (storage, accumulation) type codes
    and ``compensated`` Kahan summation; ``column_runs`` the column runs'
    tables.  The levels' tables that the rows point into, the column runs'
    with them (``column_run_of``), belong to the caller, who keeps them
    alive."""
    batch: int
    table: np.ndarray
    paths: Tuple[str, ...]
    codes: Tuple[int, int]
    compensated: bool
    column_runs: Tuple[ColumnRun, ...] = ()

    def __post_init__(self):
        self._failed = ctypes.c_int(-1)
        self._args = (self.table.ctypes.data, len(self.paths), self.batch, *self.codes,
                      int(self.compensated))
        self._failed_at = ctypes.addressof(self._failed)
        covered = self.table[:, 5].tolist() if len(self.table) else []
        self.launches = tuple((column_run_gather_reduce if n else level_gather_reduce, path,
                               max(n, 1)) for n, path in zip(covered, self.paths))
        level_launches = sum(1 for n in covered if n == 0)
        self.counts = ((level_gather_reduce, "launches", level_launches),
                       (column_run_gather_reduce, "launches", sum(1 for n in covered if n)),
                       (column_run_gather_reduce, "levels", sum(covered)))


def run_lanes(batch: int, element_size: int) -> int:
    """Threads a row of a column run takes in each block, one 16-byte load
    each (one element where the rows are not 16-byte aligned): the power of
    two, 1 to 32, that leaves RUN_BLOCKS blocks or a few more across
    ``batch``."""
    vec = 16 // element_size if batch * element_size % 16 == 0 else 1
    return min(32, 1 << max(0, (batch // (vec * RUN_BLOCKS)).bit_length() - 1))


def column_run_row(run: ColumnRun, lanes: int) -> Tuple[int, ...]:
    """A column run's row of ``LevelRun.table``: its tables' addresses, its
    rows, the launch's shape (``lanes_log2 | RUN_THREADS << 8``: ``lanes``
    threads a row, a power of two up to 32 (``run_lanes``), in blocks of
    ``RUN_THREADS``) and its levels."""
    return (run.rows.data_ptr(), run.row_fac.data_ptr(), run.level_rows.data_ptr(),
            len(run.host_rows), (lanes.bit_length() - 1) | RUN_THREADS << 8, run.n_levels,
            run.extra_idx.data_ptr(), run.extra_fac.data_ptr())


def plan_run(w: torch.Tensor, levels: Sequence[LevelTables], paths: Sequence[str], *,
             compensated: bool = False, acc_dtype: Optional[torch.dtype] = None) -> LevelRun:
    """Check once what ``level_gather_reduce`` checks at every launch, for
    the levels ``levels`` in order on buffers of ``w``'s shape, dtype and
    device, and pack their launches into a ``LevelRun``: each stretch of
    two or more consecutive levels that are thin at ``w``'s batch
    (``is_thin``, ``stretches``) one column run (``column_run_of``), each
    other level its own launch.  ``w`` only lends its shape, dtype and
    device (a tensor expanded from one element does): that each buffer is
    contiguous is the caller's to check."""
    if w.dim() != 2 or w.dtype not in STORAGE_DTYPES:
        raise ValueError(f"w must be a 2-D tensor of {STORAGE_DTYPES}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if not levels or len(levels) != len(paths):
        raise ValueError(f"a run of {len(levels)} levels and {len(paths)} paths")
    codes = cuda_type_codes(w.dtype, levels[0].fac.dtype, acc_dtype)
    for tables in levels:
        check_tables(tables, w.shape[0], w.device)
        if tables.fac.dtype != levels[0].fac.dtype:
            raise ValueError("the levels of a run take one factor dtype")
    lanes = run_lanes(w.shape[1], w.element_size())
    cuts = dict(stretches([is_thin(t, w.shape[1], w.element_size()) for t in levels]))
    rows, names, runs, i = [], [], [], 0
    while i < len(levels):
        if i in cuts:
            end = cuts[i]
            runs.append(column_run_of(levels[i:end]))
            rows.append(column_run_row(runs[-1], lanes))
            names.append(f"{paths[i].split('/')[0]}-{paths[end - 1].split('/')[0]}/run")
            i = end
        else:
            rows.append(level_row(w, levels[i]) + (0, 0, 0))
            names.append(paths[i])
            i += 1
    return LevelRun(w.shape[1], np.array(rows, np.int64).reshape(-1, len(RUN_FIELDS)),
                    tuple(names), codes, compensated, tuple(runs))


def levels_gather_reduce(w: torch.Tensor, run: LevelRun, stream: int,
                         src: Optional[torch.Tensor] = None) -> None:
    """Launch every level of ``run`` on ``w`` in place, in order, on
    ``stream`` (a raw ``cudaStream_t``), from one C call, with none of
    ``level_gather_reduce``'s checks: each level's launch reading its rows
    from ``src`` where it is given (a buffer of ``w``'s dtype and batch),
    else from ``w``, each column run one launch of its stretch, which reads
    ``w`` (the C call refuses a column run with ``src``).  ``w`` must be a
    contiguous CUDA buffer of the shape, dtype and device that ``run`` was
    planned for, on the current device.  The C call runs in the profiler
    scope ``levels``; a failed launch raises, naming its level or stretch.
    Outside a capture ``levels_gather_reduce.calls`` counts the calls,
    ``level_gather_reduce.launches`` the level launches they issued,
    ``column_run_gather_reduce.launches`` their column runs and
    ``column_run_gather_reduce.levels`` the levels those computed; in a
    capture each launch joins the manifest under its path
    (``utils.profiling.launched_run``), and each replay counts it in its
    kernel's counters."""
    lib = build.load("bucket_gather_reduce", _bind)
    with scope("levels"):
        err = lib.fd_levels_gather_reduce(w.data_ptr(), (w if src is None else src).data_ptr(),
                                          *run._args, stream, run._failed_at)
    if err != 0:
        path = run.paths[run._failed.value]
        raise RuntimeError(f"level_gather_reduce launch failed{' at level ' if path else ''}"
                           f"{path}: cudaError {err}")
    launched_run(levels_gather_reduce, run.launches, run.counts)


levels_gather_reduce.calls = 0
