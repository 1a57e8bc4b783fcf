"""Device compute path: leaf phase, graph phase and the CUDA bucket kernel."""
from .evaluator import check_lowered, evaluate_graphs, make_evaluator
from .kernels import bucket_gather_reduce, bucket_gather_reduce_plain
from .leaf_eval import LeafTables, leaf_tables_from_lowered, make_leaf_evaluator
