"""Back end: the compiled pipeline, the serialized flat-IR artifacts, and
source and Graphviz exports.

- ``compile_evaluator``: the batched evaluator on the card (production)
- ``export_artifact`` / ``load_artifact`` / ``save_lowered``: the ``.npz``
  flat-IR checkpoint, shared with the JAX package
- ``to_python_str`` / ``to_julia_str`` / ``to_c_str`` and ``compile_*``:
  source exports for interop; ``to_stablehlo`` raises (no XLA here)
- ``to_dot_str`` / ``compile_dot``: Graphviz export
"""
from .compile import (CompiledEvaluator, compile_evaluator, export_artifact,
                      leaf_graphs_of, leafmap_of, load_artifact, save_lowered)
from .source import (to_python_str, to_julia_str, to_c_str, to_stablehlo,
                     compile_python, compile_julia, compile_c)
from .to_dot import to_dot_str, compile_dot
