"""Device compute path: leaf phase, graph phase and the CUDA gather-reduce kernel."""
from .evaluator import check_lowered, evaluate_graphs, make_evaluator
from .kernels import (bucket_gather_reduce, bucket_gather_reduce_plain,
                      level_gather_reduce, level_gather_reduce_plain, pack_level,
                      unpack_level)
from .leaf_eval import LeafTables, leaf_tables_from_lowered, make_leaf_evaluator
