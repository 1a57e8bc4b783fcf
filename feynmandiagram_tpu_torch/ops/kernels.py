"""The bucket gather-reduce kernel: wrapper and plain version.

``bucket_gather_reduce`` computes, in place on the weight buffer ``w``,

    w[start + c, :] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], :]

which is the ``SumBucket`` primitive (``n_op == 1``, the function of the
Pallas kernel ``feynmandiagram_tpu/ops/kernels.py::bucket_gather_reduce``)
and the ``FusedBucket`` primitive of ``sum_mode='fused'`` (``n_op <= 4``).

On a CUDA tensor the wrapper launches the hand-written CUDA kernel in
``csrc/bucket_gather_reduce.cu``; on a CPU tensor it runs the plain PyTorch
version ``bucket_gather_reduce_plain``.  Nothing falls back: a CUDA build or
launch failure raises.  The kernel is built at first use (``ops/build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

MAX_N_OP = 4
STORAGE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)

# (storage dtype, accumulation dtype) pairs the CUDA kernel is instantiated
# for, and the type codes its C entry point takes
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
CUDA_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.float64, torch.float64),
                    (torch.float32, torch.float64), (torch.bfloat16, torch.float32))


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fd_bucket_gather_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _check(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor, start: int) -> None:
    if w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D tensor, got shape {tuple(w.shape)}")
    if w.dtype not in STORAGE_DTYPES:
        raise ValueError(f"w must be one of {STORAGE_DTYPES}, got {w.dtype}")
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
                               chunk_rows: Optional[int] = None) -> None:
    """Plain PyTorch version of the kernel, on any device, in place on ``w``.

    Term order follows the JAX evaluator: ``(w[idx[0]] * fac) * w[idx[1]] *
    ...``, then a sum over the terms (Kahan-compensated if asked).
    ``chunk_rows`` bounds the temporaries to ``n_op * arity * chunk_rows``
    gathered rows."""
    _check(w, idx, fac, start)
    n_op, arity, count = idx.shape
    a = acc_dtype or w.dtype
    step = chunk_rows or count
    for c0 in range(0, count, step):
        c1 = min(c0 + step, count)
        ix = idx[:, :, c0:c1]
        block = torch.index_select(w, 0, ix[0].reshape(-1)).view(arity, c1 - c0, -1)
        block = block.to(a) * fac[:, c0:c1, None].to(a)
        for k in range(1, n_op):
            block = block * torch.index_select(w, 0, ix[k].reshape(-1)).view(
                arity, c1 - c0, -1).to(a)
        if compensated:
            s = block[0]
            comp = torch.zeros_like(s)
            for i in range(1, arity):
                y = block[i] - comp
                t = s + y
                comp = (t - s) - y
                s = t
        else:
            s = block.sum(dim=0)
        w[start + c0:start + c1] = s.to(w.dtype)


def bucket_gather_reduce(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor,
                         start: int, *, compensated: bool = False,
                         acc_dtype: Optional[torch.dtype] = None,
                         chunk_rows: Optional[int] = None) -> None:
    """Write ``sum_a fac[a, c] * prod_k w[idx[k, a, c]]`` into rows
    ``start .. start + count`` of ``w``.

    A CUDA ``w`` launches the kernel on the current stream: it reads ``w``
    in its storage type, computes in ``acc_dtype or w.dtype`` (a pair of
    ``CUDA_DTYPE_PAIRS``, with ``fac`` in the accumulation type) and rounds
    once to ``w.dtype`` on store; ``chunk_rows`` does not apply.  A CPU ``w``
    runs ``bucket_gather_reduce_plain``.  Any other device raises.
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
            w.shape[1], start, storage, acc, int(compensated), stream)
    if err != 0:
        raise RuntimeError(f"bucket_gather_reduce launch failed: cudaError {err}")
    bucket_gather_reduce.launches += 1


bucket_gather_reduce.launches = 0
