"""Build and load the port's CUDA kernel libraries.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so``, loaded through ctypes.
A library is rebuilt when it is missing or older than its source.  The
compiler's output (with the ``-Xptxas -v`` register report) goes to
``_build/lib<name>.log``.  A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the "
                           "port's CUDA kernels")
    return nvcc


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing or older than
    the source; return the library's path."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        with open(lib[:-3] + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build ``name`` if needed, load it once per process, and let ``bind``
    declare its functions' ``argtypes`` and ``restype``."""
    if name not in _loaded:
        lib = ctypes.CDLL(build(name))
        bind(lib)
        _loaded[name] = lib
    return _loaded[name]
