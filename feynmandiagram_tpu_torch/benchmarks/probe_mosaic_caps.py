"""Row-access probes: the port of ``benchmarks/probe_mosaic_caps.py``.

The JAX script tries, on a TPU, nine Pallas kernels that read or write rows
whose index is known only at run time: an async copy of 8 rows from a
dynamic start, the same from an aligned group, a dynamic row, 8 rows and a
sum of 4 rows of a block held in VMEM, a one-hot product on the matrix
unit, a dynamic-row write, a copy to a dynamic destination, and a static
``take``.  Here each is a hand-written CUDA kernel of ``csrc/row_probes.cu``
(the source says which TPU kernel each replaces and why it is built so).
Four of them (dma8, dmagrp, vmemrow, vmem8) copy whole rows from a start
known at run time; on the card all four are one copy body, a grid of threads
that each load and store one 16-byte piece of the contiguous range, and
differ only in where the range starts.  ``case_dma8_bulk``,
``case_dmagrp_bulk``, ``case_vmemrow_bulk`` and ``case_vmem8_bulk`` compute
the same four functions by the design that was timed against that one and
lost: a TMA bulk load and bulk store through shared memory,
``BULK_CHUNK_BYTES`` a block (in one chunk, the TPU kernels' async copy into
scratch and out of it).  They are kept so that the two can be timed side by
side.  ``case_onehot_mma`` likewise computes onehot's function by the design
that was timed against its kernel of record: the select as a TF32 product on
tensor cores over the one or two k8-blocks that hold the selected rows.

For each case there is a wrapper ``case_<name>(w, rows)`` and a plain
PyTorch version ``case_<name>_plain(w, rows)``.  ``w`` is a float32 ``[S,
B]`` tensor with ``B`` a multiple of 4; ``rows`` holds the 4 int32 row
indices that the TPU kernels took as scalar prefetch.  The wrapper reads
them on the host and passes them to the kernel by value.  On a CUDA ``w``
it launches the kernel; on a CPU ``w`` it runs the plain version; on any
other device it raises.  Each wrapper counts its launches in ``.launches``.

Semantics are the reference's.  The copies (dma8, dmagrp, dmadyn_dst) have
no clamp, so the wrapper raises on a source outside ``w``.  Slices of the
``w[:256]`` block take their start as ``lax.dynamic_slice`` does: a
negative start counts once from the end, then the start is clamped into
``[0, 256 - size]``.  ``dmadyn_dst``'s output rows are its scratch rows 0..8,
which hold the copy where ``rows[1] mod 4 == 0``; elsewhere the TPU kernel
left them uninitialised, and the port defines them as zeros.  ``r mod 8``
and ``r div 8`` are floor modulo and floor division, as in ``jnp``.  Any
width ``B`` that is a multiple of 4 is taken.

``python -m feynmandiagram_tpu_torch.benchmarks.probe_mosaic_caps`` runs the
nine cases on the card at the script's shapes (``S = 4096``, ``B = 512``,
``w = arange(S*B) % 1000``, ``rows = [17, 256, 1031, 9]``).  It prints ``OK
name: first two values`` or ``FAIL``, with the kernel's and the plain
version's times and the card's name.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Callable, List, Sequence, Tuple

import torch

from . import card_name, median_ms
from ..ops import build

S, B = 4096, 512
ROWS = (17, 256, 1031, 9)
BLOCK_ROWS = 256                      # the w[:256] block of the VMEM cases
TAKE_ROWS = (3, 1, 4, 1, 5, 9, 2, 6)  # k_take's static row list (kTakeRowsPacked there)
BULK_CHUNK_BYTES = 1024               # a block's share of a *_bulk copy (16 B to 32 KB)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# per entry fd_probe_<name>: the arguments between (w, out) and (B, stream)
_ENTRY_ARGS = {"dma8": (_L,), "dmagrp": (_L,), "dmadyn_dst": (_L, _I),
               "vmemrow": (_I, _I), "vmem8": (_I, _I), "bulk": (_L, _I, _I, _I, _I),
               "acc": (_I,) * 5, "onehot": (_I, _I), "onehot_mma": (_I, _I), "dynwrite": (_I,),
               "take": (),
               # measuring tools: dma8 (group 0) or dmagrp (1) at a given
               # block size, for the sweep that chose the kernels'
               "copy8_threads": (_L, _I, _I)}


def _bind(lib: ctypes.CDLL) -> None:
    for name, extra in _ENTRY_ARGS.items():
        fn = getattr(lib, f"fd_probe_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, *extra, _I, _P]
    # the empty kernel that measures a launch's floor: (grid, threads, stream)
    lib.fd_probe_empty.restype = ctypes.c_int
    lib.fd_probe_empty.argtypes = [_I, _I, _P]


def probe_inputs(device, s: int = S, b: int = B) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's ``w`` and ``rows``; ``rows`` stays on the host."""
    w = torch.arange(s * b, dtype=torch.float32, device=device).reshape(s, b) % 1000
    return w, torch.tensor(ROWS, dtype=torch.int32)


def _host_rows(rows: torch.Tensor) -> List[int]:
    if rows.shape != (4,) or rows.dtype != torch.int32:
        raise ValueError(f"rows must be 4 int32 values, got {rows.dtype} {tuple(rows.shape)}")
    return rows.tolist()


def _block(w: torch.Tensor) -> torch.Tensor:
    return w[:BLOCK_ROWS]


def _slice_start(r: int, k: int, size: int) -> int:
    """The start of a ``size``-row slice of a ``k``-row block, as
    ``lax.dynamic_slice`` takes it: a negative start counts once from the
    end, then the start is clamped into ``[0, k - size]``."""
    if r < 0:
        r += k
    return min(max(r, 0), k - size)


# ---- plain versions (any device; the wrappers check the arguments)

def case_dma8_plain(w, rows):
    r = _host_rows(rows)[0]
    return w[r:r + 8].clone()


def case_dmagrp_plain(w, rows):
    g = _host_rows(rows)[0] // 8
    return w.reshape(w.shape[0] // 8, 8, w.shape[1])[g].clone()


def case_vmemrow_plain(w, rows):
    blk = _block(w)
    r = _slice_start(_host_rows(rows)[0], blk.shape[0], 1)
    return blk[r:r + 1].clone()


def case_vmem8_plain(w, rows):
    blk = _block(w)
    r = _slice_start(_host_rows(rows)[0], blk.shape[0], 8)
    return blk[r:r + 8].clone()


def case_acc_plain(w, rows):
    blk = _block(w)
    out = torch.zeros((1, w.shape[1]), dtype=w.dtype, device=w.device)
    for r in _host_rows(rows):
        out += blk[_slice_start(r, blk.shape[0], 1)]
    return out


def case_onehot_plain(w, rows):
    """``sel @ w[:256]``, a float32 product (exact unless TF32 is allowed)."""
    blk = _block(w)
    r = _host_rows(rows)[0]
    k = torch.arange(blk.shape[0], device=w.device)
    i = torch.arange(8, device=w.device)
    sel = (k[None, :] == r + i[:, None]).to(w.dtype)
    return sel @ blk


def case_dynwrite_plain(w, rows):
    out = torch.zeros((8, w.shape[1]), dtype=w.dtype, device=w.device)
    out[_host_rows(rows)[0] % 8] = _block(w)[0]
    return out


def case_dmadyn_dst_plain(w, rows):
    r, r1 = _host_rows(rows)[:2]
    j = r1 % 4
    scratch = torch.zeros((32, w.shape[1]), dtype=w.dtype, device=w.device)
    scratch[8 * j:8 * j + 8] = w[8 * r:8 * r + 8]
    return scratch[:8]


def case_take_plain(w, rows):
    return _block(w).index_select(0, torch.tensor(TAKE_ROWS, device=w.device))


# ---- wrappers

def _copy_src(s: int, first: int, what: str) -> None:
    """A copy of rows first .. first+8 must lie inside w's s rows: it has no clamp."""
    if not 0 <= first <= s - 8:
        raise ValueError(f"{what}: rows {first}..{first + 8} outside w's {s} rows")


# Each _args_<name>(s, b, r) checks what its kernel needs of a float32 w
# [s, b] and the row indices r, and returns the entry's arguments between
# (w, out) and (B, stream).

def _args_dma8(s, b, r):
    _copy_src(s, r[0], "dma8")
    return (r[0],)


def _args_dmagrp(s, b, r):
    if s % 8:
        raise ValueError(f"dmagrp: w's {s} rows are not groups of 8")
    _copy_src(s, 8 * (r[0] // 8), "dmagrp")
    return (r[0],)


def _args_dmadyn_dst(s, b, r):
    _copy_src(s, 8 * r[0], "dmadyn_dst")   # whatever rows[1] is, as the reference copies
    return (r[0], r[1])


def _block_rows(s: int, least: int, what: str) -> int:
    k = min(BLOCK_ROWS, s)
    if k < least:
        raise ValueError(f"{what}: needs {least} rows of w, has {k}")
    return k


def _args_vmemrow(s, b, r):
    return (r[0], _block_rows(s, 1, "vmemrow"))


def _args_vmem8(s, b, r):
    return (r[0], _block_rows(s, 8, "vmem8"))


def _args_bulk(start: int, size: int, args_of: Callable) -> Callable:
    """The arguments of ``fd_probe_bulk`` for the function whose kernel of
    record takes ``args_of``: its checks, and the chunk's."""
    def args(s, b, r):
        chunk = BULK_CHUNK_BYTES
        if chunk % 16 or not 16 <= chunk <= 32 * 1024:
            raise ValueError(f"a chunk of {chunk} bytes is no multiple of 16 up to 32 KB")
        r0, *k = args_of(s, b, r)
        return (r0, k[0] if k else s, size, start, chunk)
    return args


def _args_acc(s, b, r):
    return (*r, _block_rows(s, 1, "acc"))


def _args_onehot(s, b, r):
    k = _block_rows(s, 8, "onehot")
    # any start outside [-8, k] selects no row; clamping keeps r + i in int32
    return (min(max(r[0], -8), k), k)


def _args_dynwrite(s, b, r):
    _block_rows(s, 1, "dynwrite")
    return (r[0],)


def _args_take(s, b, r):
    _block_rows(s, max(TAKE_ROWS) + 1, "take")
    return ()


# the current stream's handle without a Stream object around it, where this
# PyTorch has the call (a CUDA build)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_handle(index: int) -> int:
    """The handle of device ``index``'s current stream."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _reject(name: str, w: torch.Tensor, rows: torch.Tensor) -> None:
    """Say which of the wrappers' common demands ``w`` or ``rows`` fails."""
    if w.device.type not in ("cuda", "cpu"):
        raise ValueError(f"case_{name} runs on cuda or cpu tensors, not {w.device.type}")
    if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D float32 tensor, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if w.shape[1] % 4 or w.data_ptr() % 16:
        raise ValueError("w's rows must be 16-byte aligned (B a multiple of 4)")
    _host_rows(rows)
    raise AssertionError("unreachable: one of the demands above failed")


def _wrapper(name: str, plain: Callable, out_rows: int, args: Callable,
             entry: str = "") -> Callable:
    """``case_<name>``: the checks, then the plain version on a CPU ``w`` or
    the launch of ``fd_probe_<entry or name>`` on a CUDA ``w``.  The C entry
    is looked up at the first launch and kept.  The demands common to all
    probes are tested in one expression, each tensor attribute read once;
    ``_reject`` words the error when it fails."""
    launch = None

    def case(w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        nonlocal launch
        device = w.device
        kind = device.type
        shape = w.shape
        if not ((kind == "cuda" or kind == "cpu") and len(shape) == 2
                and w.dtype is torch.float32 and w.is_contiguous() and shape[1] % 4 == 0
                and w.data_ptr() % 16 == 0 and rows.dtype is torch.int32
                and rows.shape == (4,)):
            _reject(name, w, rows)
        s, b = shape
        c_args = args(s, b, rows.tolist())
        if kind == "cpu":
            return plain(w, rows)
        if launch is None:
            launch = getattr(build.load("row_probes", _bind), f"fd_probe_{entry or name}")
        out = w.new_empty((out_rows, b))   # w's type and device, checked above
        stream = _stream_handle(device.index)
        if device.index == torch.cuda.current_device():
            err = launch(w.data_ptr(), out.data_ptr(), *c_args, b, stream)
        else:   # a launch goes to the current device: make it w's
            with torch.cuda.device(device):
                err = launch(w.data_ptr(), out.data_ptr(), *c_args, b, stream)
        if err != 0:
            raise RuntimeError(f"case_{name} launch failed: cudaError {err}")
        case.launches += 1
        return out

    case.__name__ = case.__qualname__ = f"case_{name}"
    case.__doc__ = (f"Launch the {name} probe kernel on a CUDA ``w``; run "
                    f"``{plain.__name__}`` on a CPU ``w``.")
    case.launches = 0
    return case


case_dma8 = _wrapper("dma8", case_dma8_plain, 8, _args_dma8)
case_dmagrp = _wrapper("dmagrp", case_dmagrp_plain, 8, _args_dmagrp)
case_vmemrow = _wrapper("vmemrow", case_vmemrow_plain, 1, _args_vmemrow)
case_vmem8 = _wrapper("vmem8", case_vmem8_plain, 8, _args_vmem8)
case_acc = _wrapper("acc", case_acc_plain, 1, _args_acc)
case_onehot = _wrapper("onehot", case_onehot_plain, 8, _args_onehot)
case_dynwrite = _wrapper("dynwrite", case_dynwrite_plain, 8, _args_dynwrite)
case_dmadyn_dst = _wrapper("dmadyn_dst", case_dmadyn_dst_plain, 8, _args_dmadyn_dst)
case_take = _wrapper("take", case_take_plain, 8, _args_take)
# the TMA design of the four copies (a bulk load and a bulk store through
# shared memory, BULK_CHUNK_BYTES a block), kept to be timed beside the
# kernels above; the second argument of _args_bulk is row_probes.cu's Start
case_dma8_bulk = _wrapper("dma8_bulk", case_dma8_plain, 8, _args_bulk(1, 8, _args_dma8),
                          entry="bulk")
case_dmagrp_bulk = _wrapper("dmagrp_bulk", case_dmagrp_plain, 8,
                            _args_bulk(2, 8, _args_dmagrp), entry="bulk")
case_vmemrow_bulk = _wrapper("vmemrow_bulk", case_vmemrow_plain, 1,
                             _args_bulk(0, 1, _args_vmemrow), entry="bulk")
case_vmem8_bulk = _wrapper("vmem8_bulk", case_vmem8_plain, 8, _args_bulk(0, 8, _args_vmem8),
                           entry="bulk")
# onehot's select on tensor cores (TF32 mma.sync over only the k-steps that
# can hold a 1), kept to be timed beside case_onehot, the select as a read
case_onehot_mma = _wrapper("onehot_mma", case_onehot_plain, 8, _args_onehot)

# (label, wrapper, plain version), in the JAX script's order
CASES: Sequence[Tuple[str, Callable, Callable]] = (
    ("unaligned dyn-start (r,8) copy, a 16-byte piece a thread", case_dma8, case_dma8_plain),
    ("aligned group copy w3[g] (8,B), the same body", case_dmagrp, case_dmagrp_plain),
    ("dyn 1-row read of w[:256], only that row moved", case_vmemrow, case_vmemrow_plain),
    ("dyn 8-row read of w[:256] unaligned, only those rows moved", case_vmem8,
     case_vmem8_plain),
    ("accumulate 4 dyn rows of w[:256] into row 0, only those rows read", case_acc,
     case_acc_plain),
    ("one-hot select of 8 rows of w[:256] as a read, only those rows read", case_onehot,
     case_onehot_plain),
    ("dyn-position 1-row write, a 16-byte piece a thread, a block row an output row",
     case_dynwrite, case_dynwrite_plain),
    ("dyn src + dyn dst offsets, the copy or zeros, a 16-byte piece a thread", case_dmadyn_dst,
     case_dmadyn_dst_plain),
    ("static take of 8 rows of w[:256], a 16-byte piece a thread", case_take, case_take_plain),
)


def main() -> List[dict]:
    """Run every case on the card, as the JAX script's ``try_case`` loop
    does, and time kernel and plain version (``median_ms``).
    Returns one dict per case: label, wrapper, ok, first values, times."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_mosaic_caps needs a CUDA card")
    card = card_name()
    w, rows = probe_inputs("cuda")
    results = []
    for label, case, plain in CASES:
        res = {"label": label, "case": case, "ok": False}
        try:
            out = case(w, rows)
            torch.cuda.synchronize()
            res.update(ok=True, first=out.reshape(-1)[:2].tolist(),
                       ms=median_ms(lambda: case(w, rows)),
                       plain_ms=median_ms(lambda: plain(w, rows)))
            print(f"OK    {label}: {res['first']}  kernel {res['ms']:.4f} ms, plain "
                  f"{res['plain_ms']:.4f} ms  [{card}]", flush=True)
        except Exception as e:  # a probe reports each failing case and goes on
            msg = (str(e).splitlines() or [""])[0][:160]
            print(f"FAIL  {label}: {type(e).__name__}: {msg}", flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
