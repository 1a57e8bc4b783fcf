"""Device compute path: leaf phase, graph phase and the CUDA gather-reduce kernel.

The lowering and its plan classes are exported as in the JAX package.  Its
``recommended_batch`` is not: that rule sizes a batch to the TPU's VMEM, and
the port's batch rule is to come from measurements on the card.
"""
from .lowering import lower, LoweredGraph, LevelPlan, SumPlan, ProdPlan, PowerPlan
from .evaluator import check_lowered, evaluate_graphs, make_evaluator
from .kernels import (bucket_gather_reduce, bucket_gather_reduce_plain,
                      level_gather_reduce, level_gather_reduce_plain, pack_level,
                      unpack_level)
from .leaf_eval import LeafTables, leaf_tables_from_lowered, make_leaf_evaluator
