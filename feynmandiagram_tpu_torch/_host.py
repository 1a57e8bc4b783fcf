"""Jax-free access to the host pipeline of ``feynmandiagram_tpu``.

The port reuses the JAX package's host side as it is: the Parquet front
end, the graph IR and optimizer, the native CSE and ``ops/lowering.py``.
Those modules are plain Python and numpy, but two package ``__init__``
files pull jax in: ``feynmandiagram_tpu/__init__.py`` imports ``models``
(which imports jax) and ``feynmandiagram_tpu/ops/__init__.py`` imports the
jax evaluator.  Where jax is installed the packages import normally.  Where
it is not, as on a CUDA machine, the two parent packages are registered as
bare modules (``__path__`` set, ``__init__`` not run), so that their
jax-free submodules import on their own.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import types

_PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "feynmandiagram_tpu")


def _register_bare(name: str, path: str) -> None:
    if name not in sys.modules:
        mod = types.ModuleType(name)
        mod.__path__ = [path]
        mod.__file__ = os.path.join(path, "__init__.py")
        sys.modules[name] = mod


if importlib.util.find_spec("jax") is None:
    # host graph generation recurses over deep DAGs, as in the package __init__
    if sys.getrecursionlimit() < 100000:
        sys.setrecursionlimit(100000)
    _register_bare("feynmandiagram_tpu", _PKG_DIR)
    _register_bare("feynmandiagram_tpu.ops", os.path.join(_PKG_DIR, "ops"))

from feynmandiagram_tpu.computational_graph import Graph, optimize_inplace  # noqa: E402
from feynmandiagram_tpu.frontends import (BareGreenId, BareInteractionId,  # noqa: E402
                                          ChargeCharge, Instant, NoHartree)
from feynmandiagram_tpu.frontends.parquet import (DiagPara, Interaction,  # noqa: E402
                                                  SigmaDiag, Ver4Diag, sigma, vertex4)
from feynmandiagram_tpu.ops.lowering import (FusedBucket, LevelPlan,  # noqa: E402
                                             LoweredGraph, PowerPlan, ProdPlan,
                                             SumBucket, SumPlan, lower)

__all__ = ["Graph", "optimize_inplace", "BareGreenId", "BareInteractionId",
           "ChargeCharge", "Instant", "NoHartree", "DiagPara", "Interaction",
           "SigmaDiag", "Ver4Diag", "sigma", "vertex4", "FusedBucket", "LevelPlan",
           "LoweredGraph", "PowerPlan", "ProdPlan", "SumBucket", "SumPlan", "lower"]
