"""The bucket gather-reduce kernel: wrapper, plain version and build step.

``bucket_gather_reduce`` computes, in place on the weight buffer ``w``,

    w[start + c, :] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], :]

which is the ``SumBucket`` primitive (``n_op == 1``, the function of the
Pallas kernel ``feynmandiagram_tpu/ops/kernels.py::bucket_gather_reduce``)
and the ``FusedBucket`` primitive of ``sum_mode='fused'`` (``n_op <= 4``).

On a CUDA tensor the wrapper launches the hand-written CUDA kernel in
``csrc/bucket_gather_reduce.cu``; on a CPU tensor it runs the plain PyTorch
version ``bucket_gather_reduce_plain``.  Nothing falls back: a CUDA build or
launch failure raises.  The kernel is built at first use with ``nvcc`` into
``feynmandiagram_tpu_torch/_build/`` and loaded through ctypes.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

MAX_N_OP = 4

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "bucket_gather_reduce.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbucket_gather_reduce.so")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build "
                           "the bucket_gather_reduce CUDA kernel")
    return nvcc


def build() -> str:
    """Compile the kernel into ``_build/`` if the library is missing or
    older than its source; return the library's path.  The compiler's output
    (including ``-Xptxas -v`` register counts) goes to ``_build/*.log``."""
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    nvcc = _find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        with open(_LIB_PATH[:-3] + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.fd_bucket_gather_reduce
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(w: torch.Tensor, idx: torch.Tensor, fac: torch.Tensor, start: int) -> None:
    if w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D tensor, got shape {tuple(w.shape)}")
    if w.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"w must be float32 or float64, got {w.dtype}")
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

    A CUDA ``w`` launches the kernel on the current stream (it accumulates in
    ``w``'s type and takes no ``acc_dtype`` other than that; ``chunk_rows``
    does not apply).  A CPU ``w`` runs ``bucket_gather_reduce_plain``.  Any
    other device raises.  ``bucket_gather_reduce.launches`` counts kernel
    launches.
    """
    if w.device.type == "cpu":
        bucket_gather_reduce_plain(w, idx, fac, start, compensated=compensated,
                                   acc_dtype=acc_dtype, chunk_rows=chunk_rows)
        return
    if w.device.type != "cuda":
        raise ValueError(f"bucket_gather_reduce runs on cuda or cpu tensors, "
                         f"not {w.device.type}")
    _check(w, idx, fac, start)
    if fac.dtype != w.dtype:
        raise ValueError(f"fac dtype {fac.dtype} differs from w dtype {w.dtype}")
    if acc_dtype not in (None, w.dtype):
        raise ValueError(f"the CUDA kernel accumulates in w's dtype {w.dtype}, "
                         f"not {acc_dtype}")
    lib = _load()
    n_op, arity, count = idx.shape
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.fd_bucket_gather_reduce(
            w.data_ptr(), idx.data_ptr(), fac.data_ptr(), n_op, arity, count,
            w.shape[1], start, int(w.dtype == torch.float64), int(compensated), stream)
    if err != 0:
        raise RuntimeError(f"bucket_gather_reduce launch failed: cudaError {err}")
    bucket_gather_reduce.launches += 1


bucket_gather_reduce.launches = 0
