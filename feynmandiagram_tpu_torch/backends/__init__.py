"""Back end: the compiled pipeline and the serialized flat-IR artifacts."""
from .compile import (CompiledEvaluator, compile_evaluator, export_artifact,
                      leaf_graphs_of, leafmap_of, load_artifact, save_lowered)
