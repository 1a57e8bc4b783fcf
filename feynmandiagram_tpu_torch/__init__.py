"""feynmandiagram_tpu_torch: the PyTorch and CUDA port of feynmandiagram_tpu.

The package stands on its own: it imports torch and numpy, never jax and
nothing of the JAX package.  The host pipeline is a copy of the JAX
package's, path for path: ``computational_graph`` (graph IR, optimizer),
``taylor`` and ``utility`` (Taylor-mode AD, ``taylorAD``),
``quantum_operators``, ``frontends`` (Parquet, the GV reader and its
``groups_vertex4`` tables), ``ops.lowering`` and ``native`` (the C++ CSE
helper ``csrc/graphcore.cpp`` with its numpy path).  The device side is
ported: ``ops`` (leaf phase, graph phase, the hand-written CUDA
gather-reduce kernel, one launch per level, and the kernels' build),
``models`` (G and V physics, the Hubbard-atom oracle and the
exact-diagonalization oracle ``atom_ed``), ``backends.compile`` (the whole
pipeline and the ``.npz`` artifacts), ``mc`` (the Monte-Carlo throughput
protocol) and ``benchmarks`` (the row-access probes, nine hand-written CUDA
kernels, the gather probe, and the config-4 counterterm series
``bench_config4``).  Module names mirror the JAX package's.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
import sys as _sys

# Host-side graph generation is recursive over combinatorially deep DAGs.
if _sys.getrecursionlimit() < 100000:
    _sys.setrecursionlimit(100000)

__version__ = "0.1.0"

from . import taylor  # noqa: E402
from . import utility  # noqa: E402
