"""Build and load the port's native libraries.

Each CUDA source ``csrc/<name>.cu`` has a plain C interface and is compiled
with ``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so``, loaded through
ctypes.  A library is rebuilt when it is missing or older than its source.
The compiler's output (with the ``-Xptxas -v`` register report) goes to
``_build/lib<name>.log``.  A missing ``nvcc`` or a failed build raises: there
is no fallback.  The host helper ``csrc/graphcore.cpp`` is compiled the same
way with ``g++`` (``build_host``); its caller, ``native``, has a numpy path
for machines without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-split-compile=0",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

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


def _compile(src: str, name: str, compiler: Callable[[], List[str]]) -> str:
    """Compile ``src`` into ``_build/lib<name>.so`` if that is missing or
    older than the source; ``compiler()`` gives the command up to ``-o``."""
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    cmd = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True, text=True)
        with open(lib[:-3] + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed on "
                               f"{os.path.basename(src)} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` with nvcc if its library is missing or
    older than the source; return the library's path."""
    return _compile(os.path.join(SRC_DIR, f"{name}.cu"), name,
                    lambda: [_find_nvcc(), *NVCC_FLAGS])


def build_host(name: str) -> str:
    """Compile the host source ``csrc/<name>.cpp`` with g++ likewise.
    Raises ``RuntimeError`` where there is no g++ or the build fails."""
    def gxx() -> List[str]:
        path = shutil.which("g++")
        if path is None:
            raise RuntimeError("g++ not found on PATH")
        return [path, *GXX_FLAGS]

    return _compile(os.path.join(SRC_DIR, f"{name}.cpp"), name, gxx)


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build ``name`` if needed, load it once per process, and let ``bind``
    declare its functions' ``argtypes`` and ``restype``."""
    if name not in _loaded:
        lib = ctypes.CDLL(build(name))
        bind(lib)
        _loaded[name] = lib
    return _loaded[name]
