"""Native (C++) host-runtime kernels, loaded via ctypes.

``graphcore`` accelerates the host-side IR pipeline on large DAGs:
structural hash-consing (CSE) and topological leveling over the flattened
record arrays.  The shared library is compiled on demand with g++ from
``csrc/graphcore.cpp`` into the package's ``_build/`` directory
(``ops/build.py``); every entry point has a pure-numpy path behind it, so
the native path is an accelerator, not a dependency.  ``native_available()``
says which of the two runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..ops import build

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if _build_failed:
        return None
    try:
        lib = ctypes.CDLL(build.build_host("graphcore"))
    except (OSError, RuntimeError):
        # no compiler, a failed build or an unloadable library: numpy path
        _build_failed = True
        return None
    lib.fd_cse.restype = ctypes.c_int64
    lib.fd_cse.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.fd_depth.restype = None
    lib.fd_depth.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        _lib = _build()
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def cse(ops: np.ndarray, powers: np.ndarray, prop: np.ndarray,
        edge_ptr: np.ndarray, edge_src: np.ndarray, edge_fac: np.ndarray
        ) -> Tuple[np.ndarray, int]:
    """Structural CSE over postordered records; returns (remap, n_canonical).

    remap[i] is the index of node i's canonical representative (<= i).
    """
    n = len(ops)
    remap = np.zeros(n, np.int64)
    lib = get_lib()
    if lib is not None:
        n_canon = lib.fd_cse(n, np.ascontiguousarray(ops, np.int8),
                             np.ascontiguousarray(powers, np.int32),
                             np.ascontiguousarray(prop, np.uint64),
                             np.ascontiguousarray(edge_ptr, np.int64),
                             np.ascontiguousarray(edge_src, np.int64),
                             np.ascontiguousarray(edge_fac, np.float64),
                             remap)
        return remap, int(n_canon)
    # numpy/python fallback: identical algorithm
    canon = {}
    n_canon = 0
    for i in range(n):
        kids = sorted((int(remap[edge_src[e]]), float(edge_fac[e]))
                      for e in range(edge_ptr[i], edge_ptr[i + 1]))
        key = (int(ops[i]), int(powers[i]), int(prop[i]), tuple(kids))
        if key in canon:
            remap[i] = canon[key]
        else:
            canon[key] = i
            remap[i] = i
            n_canon += 1
    return remap, n_canon


def depth(edge_ptr: np.ndarray, edge_src: np.ndarray) -> np.ndarray:
    n = len(edge_ptr) - 1
    out = np.zeros(n, np.int32)
    lib = get_lib()
    if lib is not None:
        lib.fd_depth(n, np.ascontiguousarray(edge_ptr, np.int64),
                     np.ascontiguousarray(edge_src, np.int64), out)
        return out
    for i in range(n):
        es = edge_src[edge_ptr[i]:edge_ptr[i + 1]]
        out[i] = 0 if len(es) == 0 else out[es].max() + 1
    return out
