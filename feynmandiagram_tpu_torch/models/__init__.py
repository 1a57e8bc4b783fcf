"""Physics models: vectorized leaf kernels for the batched evaluator."""
from .free_fermion import TAU_CUTOFF, green_derive_tower, green_kernel
from .yukawa import interaction_derive, yukawa_interaction
