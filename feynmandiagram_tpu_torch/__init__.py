"""feynmandiagram_tpu_torch: the PyTorch and CUDA port of feynmandiagram_tpu.

The package stands on its own: it imports torch and numpy, never jax and
nothing of the JAX package.  Its modules mirror the JAX package's, name for
name, and so does its top level: ``computational_graph``,
``quantum_operators``, ``taylor``, ``utility``, ``frontends`` and ``models``
are imported with the package; ``ops``, ``backends`` and ``parallel`` load
on first access.

- Host side, copies of the JAX package's code: the front ends (Parquet, the
  GV reader, its tables and their generator ``frontends.gv.generator``),
  the graph IR and optimizer, Taylor-mode AD (``taylor``, ``utility``),
  ``ops.lowering`` and the C++ CSE helper (``native``).
- Device side, ported: ``ops`` (leaf phase, graph phase, the hand-written
  CUDA gather-reduce kernel, one launch per level, and the kernels' build),
  ``models`` (G and V physics and the two oracles), ``backends``
  (``compile_evaluator``, the ``.npz`` artifacts, source and DOT exports),
  ``parallel`` (meshes, the sample axis, the graph-sharded evaluator),
  ``utils`` (distributed start-up, profiling), ``mc`` (the Monte-Carlo
  throughput protocol) and ``benchmarks`` (the row-access probes, the
  gather probe, config 4, the per-phase profile of a pass).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; kernels build at their first launch, never at import.
"""
import sys as _sys

# Host-side graph generation is recursive over combinatorially deep DAGs.
if _sys.getrecursionlimit() < 100000:
    _sys.setrecursionlimit(100000)

__version__ = "0.1.0"

from . import computational_graph  # noqa: E402
from . import quantum_operators  # noqa: E402
from . import taylor  # noqa: E402
from . import utility  # noqa: E402
from . import frontends  # noqa: E402
from . import models  # noqa: E402

# the device layers are imported on first access
_LAZY = {"ops", "backends", "parallel"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
