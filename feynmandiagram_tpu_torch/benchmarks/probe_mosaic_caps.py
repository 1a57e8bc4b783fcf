"""Row-access probes: the port of ``benchmarks/probe_mosaic_caps.py``.

The JAX script tries, on a TPU, nine Pallas kernels that read or write rows
whose index is known only at run time: an async copy of 8 rows from a
dynamic start, the same from an aligned group, a dynamic row, 8 rows and a
sum of 4 rows of a block held in VMEM, a one-hot product on the matrix
unit, a dynamic-row write, a copy to a dynamic destination, and a static
``take``.  Here each is a hand-written CUDA kernel of ``csrc/row_probes.cu``
(the source says which TPU kernel each replaces and why it is built so).
``case_vmemrow_bulk`` and ``case_vmem8_bulk`` compute what ``case_vmemrow``
and ``case_vmem8`` do by the design that was timed against theirs, a TMA
bulk load and bulk store through shared memory.

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
``[0, 256 - size]``.  ``dmadyn_dst`` zero-fills its scratch, whose
other rows the TPU kernel left uninitialised.  ``r mod 8`` and ``r div 8``
are floor modulo and floor division, as in ``jnp``.

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
TAKE_ROWS = (3, 1, 4, 1, 5, 9, 2, 6)  # k_take's static row list
SMEM_BYTES = 227 * 1024               # shared memory a block can have
BULK_CHUNK_BYTES = 1024               # a block's share of a *_bulk copy (16 B to 32 KB)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# per entry fd_probe_<name>: the arguments between (w, out) and (B, stream)
_ENTRY_ARGS = {"dma8": (_L,), "dmagrp": (_L,), "dmadyn_dst": (_L, _I),
               "vmemrow": (_I, _I), "vmem8": (_I, _I), "vmem_bulk": (_I,) * 4,
               "acc": (_I,) * 5, "onehot": (_I, _I), "dynwrite": (_I,), "take": ()}


def _bind(lib: ctypes.CDLL) -> None:
    for name, extra in _ENTRY_ARGS.items():
        fn = getattr(lib, f"fd_probe_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, *extra, _I, _P]


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

def _copy_src(w, first: int, what: str) -> None:
    """A copy of rows first .. first+8 must lie inside w: it has no clamp."""
    if not 0 <= first <= w.shape[0] - 8:
        raise ValueError(f"{what}: rows {first}..{first + 8} outside w's {w.shape[0]} rows")


def _smem(w, rows_held: int, what: str) -> None:
    if rows_held * w.shape[1] * w.element_size() > SMEM_BYTES:
        raise ValueError(f"{what}: {rows_held} rows of {w.shape[1]} floats exceed a block's "
                         f"shared memory")


def _args_dma8(w, r):
    _copy_src(w, r[0], "dma8")
    _smem(w, 8, "dma8")
    return (r[0],)


def _args_dmagrp(w, r):
    if w.shape[0] % 8:
        raise ValueError(f"dmagrp: w's {w.shape[0]} rows are not groups of 8")
    _copy_src(w, 8 * (r[0] // 8), "dmagrp")
    _smem(w, 8, "dmagrp")
    return (r[0],)


def _args_dmadyn_dst(w, r):
    _copy_src(w, 8 * r[0], "dmadyn_dst")
    _smem(w, 32, "dmadyn_dst")
    return (r[0], r[1])


def _block_rows(w, least: int, what: str) -> int:
    k = min(BLOCK_ROWS, w.shape[0])
    if k < least:
        raise ValueError(f"{what}: needs {least} rows of w, has {k}")
    return k


def _args_vmemrow(w, r):
    return (r[0], _block_rows(w, 1, "vmemrow"))


def _args_vmem8(w, r):
    return (r[0], _block_rows(w, 8, "vmem8"))


def _args_bulk(size: int, what: str) -> Callable:
    def args(w, r):
        chunk = BULK_CHUNK_BYTES
        if chunk % 16 or not 16 <= chunk <= 32 * 1024:
            raise ValueError(f"{what}: a chunk of {chunk} bytes is no multiple of 16 up to 32 KB")
        return (r[0], _block_rows(w, size, what), size, chunk)
    return args


def _args_acc(w, r):
    return (*r, _block_rows(w, 1, "acc"))


def _args_onehot(w, r):
    k = _block_rows(w, 8, "onehot")
    if k % 8:
        raise ValueError(f"onehot: the block's {k} rows are not a multiple of 8")
    # any start outside [-8, k] selects no row; clamping keeps r + i in int32
    return (min(max(r[0], -8), k), k)


def _args_dynwrite(w, r):
    _block_rows(w, 1, "dynwrite")
    return (r[0],)


def _args_take(w, r):
    _block_rows(w, max(TAKE_ROWS) + 1, "take")
    return ()


# the current stream's handle without a Stream object around it, where this
# PyTorch has the call (a CUDA build)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_handle(index: int) -> int:
    """The handle of device ``index``'s current stream."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _wrapper(name: str, plain: Callable, out_rows: int, args: Callable,
             entry: str = "") -> Callable:
    """``case_<name>``: the checks, then the plain version on a CPU ``w`` or
    the launch of ``fd_probe_<entry or name>`` on a CUDA ``w``.  The C entry
    is looked up at the first launch and kept."""
    launch = None

    def case(w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        nonlocal launch
        device = w.device
        if device.type != "cuda" and device.type != "cpu":
            raise ValueError(f"case_{name} runs on cuda or cpu tensors, not {device.type}")
        if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"w must be a contiguous 2-D float32 tensor, got {w.dtype} "
                             f"{tuple(w.shape)}")
        b, w_ptr = w.shape[1], w.data_ptr()
        if b % 4 or w_ptr % 16:
            raise ValueError("w's rows must be 16-byte aligned (B a multiple of 4)")
        c_args = args(w, _host_rows(rows))
        if device.type == "cpu":
            return plain(w, rows)
        if launch is None:
            launch = getattr(build.load("row_probes", _bind), f"fd_probe_{entry or name}")
        out = w.new_empty((out_rows, b))   # w's type and device, checked above
        stream = _stream_handle(device.index)
        if device.index == torch.cuda.current_device():
            err = launch(w_ptr, out.data_ptr(), *c_args, b, stream)
        else:   # a launch goes to the current device: make it w's
            with torch.cuda.device(device):
                err = launch(w_ptr, out.data_ptr(), *c_args, b, stream)
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
# the TMA design of the two slices, kept to be timed beside the kernels above
case_vmemrow_bulk = _wrapper("vmemrow_bulk", case_vmemrow_plain, 1,
                             _args_bulk(1, "vmemrow_bulk"), entry="vmem_bulk")
case_vmem8_bulk = _wrapper("vmem8_bulk", case_vmem8_plain, 8, _args_bulk(8, "vmem8_bulk"),
                           entry="vmem_bulk")

# (label, wrapper, plain version), in the JAX script's order
CASES: Sequence[Tuple[str, Callable, Callable]] = (
    ("unaligned dyn-start (r,8) bulk copy to shared", case_dma8, case_dma8_plain),
    ("aligned group bulk copy w3[g] (8,B)", case_dmagrp, case_dmagrp_plain),
    ("dyn 1-row read of w[:256], only that row moved", case_vmemrow, case_vmemrow_plain),
    ("dyn 8-row read of w[:256] unaligned, only those rows moved", case_vmem8,
     case_vmem8_plain),
    ("accumulate dyn rows into row 0", case_acc, case_acc_plain),
    ("one-hot tensor-core select", case_onehot, case_onehot_plain),
    ("dyn-position 1-row write", case_dynwrite, case_dynwrite_plain),
    ("bulk copy dyn src + dyn dst offsets", case_dmadyn_dst, case_dmadyn_dst_plain),
    ("static take in shared memory", case_take, case_take_plain),
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
