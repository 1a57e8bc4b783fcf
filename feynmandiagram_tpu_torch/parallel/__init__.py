"""Scale-out of the port: meshes, sample-axis data parallelism and the
graph-sharded evaluator, on ``torch.distributed``.

Port of ``feynmandiagram_tpu/parallel``.  A mesh axis is local (all its
ranks in this process, on one device) or distributed over a process group;
the Monte-Carlo sample axis needs no exchange until its means reduce, and
the graph-sharded evaluator exchanges each level's halo.
"""
from .sharding import (Mesh, make_sample_mesh, shard_compiled, make_mc_step, rank_seed,
                       BATCH_AXIS)
from .graph_shard import (make_graph_sharded_evaluator, make_graph_sharded_mc_step,
                          lower_sharded_best, GRAPH_AXIS)
