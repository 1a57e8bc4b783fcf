"""The gather-reduce kernel: wrappers, the level tables and plain versions.

For a bucket ``(idx [n_op, arity, count], fac [arity, count], start)`` the
kernel computes, in place on the weight buffer ``w``,

    w[start + c, :] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], :]

which is the ``SumBucket`` primitive (``n_op == 1``, the function of the
Pallas kernel ``feynmandiagram_tpu/ops/kernels.py::bucket_gather_reduce``)
and the ``FusedBucket`` primitive of ``sum_mode='fused'`` (``n_op <= 4``).

``level_gather_reduce`` does that for all buckets of a level in one launch,
from tables that ``pack_level`` packs once and uploads: no bucket of a level
reads a row that another one writes (``ops/evaluator.py::check_lowered``), so
they may run at once.  Given ``src``, a level reads its rows from that buffer
instead of ``w`` (the halo of a graph-sharded level,
``parallel/graph_shard.py``) and writes them to ``w``.
``bucket_gather_reduce`` is the one-bucket call of the same kernel.  On a
CUDA tensor either wrapper launches the hand-written CUDA kernel in
``csrc/bucket_gather_reduce.cu``; on a CPU tensor it runs its plain PyTorch
version.  Nothing falls back: a CUDA build or launch failure raises.
The kernel is built at first use (``ops/build.py``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

MAX_N_OP = 4
STORAGE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)

# (storage dtype, accumulation dtype) pairs the CUDA kernel is instantiated
# for, and the type codes its C entry point takes
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
CUDA_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.float64, torch.float64),
                    (torch.float32, torch.float64), (torch.bfloat16, torch.float32))


# the kernel's geometry (csrc/bucket_gather_reduce.cu): output rows of a row
# tile, the int32 columns of a record of the tile table on the device, and
# those of a bucket's descriptor on the host
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
# arity limits of ``_record_width``, TARGET_BLOCKS and L2_GROUP_BYTES come
# from the sweep of ``chip_smoke.py`` (its ``geometry:`` lines; PERF.md has
# the numbers).
PIECE_BYTES = 32 * 16
ITEM_PIECES = 8
RECORD_WIDTHS = (4, 2, 1)
TARGET_BLOCKS = 528
L2_GROUP_BYTES = 24 * 2 ** 20


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fd_bucket_gather_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn = lib.fd_level_gather_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]


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
                         chunk_rows: Optional[int] = None,
                         geometry: Optional[Tuple[int, int]] = None) -> None:
    """Write ``sum_a fac[a, c] * prod_k w[idx[k, a, c]]`` into rows
    ``start .. start + count`` of ``w``.

    A CUDA ``w`` launches the kernel on the current stream: it reads ``w``
    in its storage type, computes in ``acc_dtype or w.dtype`` (a pair of
    ``CUDA_DTYPE_PAIRS``, with ``fac`` in the accumulation type) and rounds
    once to ``w.dtype`` on store; ``chunk_rows`` does not apply, and
    ``geometry`` (the widest record, one of ``RECORD_WIDTHS``, and the bytes
    of ``w`` that a column group may touch; by default the widest that leaves
    ``TARGET_BLOCKS`` blocks, and ``L2_GROUP_BYTES``) changes the order of the
    work and not the result.  A CPU
    ``w`` runs ``bucket_gather_reduce_plain``.  Any other device raises.
    ``bucket_gather_reduce.launches`` counts kernel launches.
    """
    if w.device.type == "cpu":
        bucket_gather_reduce_plain(w, idx, fac, start, compensated=compensated,
                                   acc_dtype=acc_dtype, chunk_rows=chunk_rows)
        return
    if w.device.type != "cuda":
        raise ValueError(f"bucket_gather_reduce runs on cuda or cpu tensors, "
                         f"not {w.device.type}")
    _check(w, idx, fac, start)
    storage, acc = cuda_type_codes(w.dtype, fac.dtype, acc_dtype)
    lib = build.load("bucket_gather_reduce", _bind)
    n_op, arity, count = idx.shape
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.fd_bucket_gather_reduce(
            w.data_ptr(), idx.data_ptr(), fac.data_ptr(), n_op, arity, count,
            w.shape[1], start, storage, acc, int(compensated),
            _bucket_pieces(w, arity, count, geometry),
            _group_cols(w, (n_op * arity + 1) * count, geometry), stream)
    if err != 0:
        raise RuntimeError(f"bucket_gather_reduce launch failed: cudaError {err}")
    bucket_gather_reduce.launches += 1


bucket_gather_reduce.launches = 0


def _items_across(w: torch.Tensor) -> int:
    return -(-w.shape[1] * w.element_size() // (ITEM_PIECES * PIECE_BYTES))


def _record_width(arity: int, widest: int) -> int:
    """Pieces of an item that one block takes of a row tile of ``arity``
    terms, where the launch's widest records have ``widest``."""
    if arity < 4:
        return widest
    return min(widest, 2) if arity < 16 else 1


def _bucket_pieces(w: torch.Tensor, arity: int, count: int,
                   geometry: Optional[Tuple[int, int]]) -> int:
    """The record width for a one-bucket launch: the widest that leaves
    TARGET_BLOCKS blocks, or the one that ``geometry`` names."""
    tiles = -(-count // TILE_ROWS) * _items_across(w)
    for widest in RECORD_WIDTHS if geometry is None else (geometry[0],):
        width = _record_width(arity, widest)
        if tiles * (ITEM_PIECES // width) >= TARGET_BLOCKS:
            break
    return width


def _group_cols(w: torch.Tensor, rows_touched: int,
                geometry: Optional[Tuple[int, int]]) -> int:
    """The width of a column group in columns of ``w``, for a launch that
    touches ``rows_touched`` rows (the kernel rounds it to whole items)."""
    budget = L2_GROUP_BYTES if geometry is None else geometry[1]
    return max(budget // (rows_touched * w.element_size()), 1)


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
    writes."""
    idx: torch.Tensor
    fac: torch.Tensor
    records: Dict[int, torch.Tensor]
    desc: np.ndarray
    row_end: int
    max_index: int
    rows_touched: int

    def records_for(self, w: torch.Tensor,
                    geometry: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The tile table for a launch on ``w``: the widest records that
        leave TARGET_BLOCKS blocks, or those that ``geometry`` names."""
        across = _items_across(w)
        for widest in RECORD_WIDTHS if geometry is None else (geometry[0],):
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
        rows_touched=len(np.unique(idx_pool)) + int(desc[:, 1].sum()))


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
    if tables.row_end > w.shape[0]:
        raise ValueError(f"the level writes rows up to {tables.row_end} of w's {w.shape[0]}")
    if tables.max_index >= rows.shape[0]:
        raise ValueError(f"the level reads row {tables.max_index} of a buffer of "
                         f"{rows.shape[0]} rows")


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
                        geometry: Optional[Tuple[int, int]] = None,
                        src: Optional[torch.Tensor] = None) -> None:
    """Run every bucket of ``tables`` on ``w``, in place.

    The indices are rows of ``src`` where it is given (a buffer of ``w``'s
    device, dtype and batch), else of ``w``; the outputs go to ``w``.
    Every call checks that the level's rows lie inside ``w`` and its indices
    inside the buffer it reads.  A CUDA ``w`` launches the kernel once, on
    the current stream, with the types, rounding and ``geometry`` of
    ``bucket_gather_reduce``; reading ``w`` itself, the caller guarantees
    that no bucket reads a destination row of the level
    (``check_lowered``).  A CPU ``w`` runs ``level_gather_reduce_plain``.
    Any other device raises.  ``level_gather_reduce.launches`` counts kernel
    launches."""
    if w.device.type == "cpu":
        level_gather_reduce_plain(w, tables, compensated=compensated, acc_dtype=acc_dtype,
                                  chunk_rows=chunk_rows, src=src)
        return
    if w.device.type != "cuda":
        raise ValueError(f"level_gather_reduce runs on cuda or cpu tensors, "
                         f"not {w.device.type}")
    _check_level(w, tables, src)
    records = tables.records_for(w, geometry)
    if not (tables.idx.device == w.device and tables.fac.device == w.device
            and records.device == w.device):
        raise ValueError("w and the level tables must lie on one device")
    storage, acc = cuda_type_codes(w.dtype, tables.fac.dtype, acc_dtype)
    lib = build.load("bucket_gather_reduce", _bind)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.fd_level_gather_reduce(
            w.data_ptr(), (w if src is None else src).data_ptr(),
            tables.idx.data_ptr(), tables.fac.data_ptr(),
            records.data_ptr(), records.shape[0], w.shape[1], storage, acc,
            int(compensated), _group_cols(w, tables.rows_touched, geometry), stream)
    if err != 0:
        raise RuntimeError(f"level_gather_reduce launch failed: cudaError {err}")
    level_gather_reduce.launches += 1


level_gather_reduce.launches = 0
