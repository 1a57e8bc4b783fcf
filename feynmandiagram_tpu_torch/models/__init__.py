"""Physics models: vectorized leaf kernels for the batched evaluator, and the
Hubbard-atom self-energy oracle."""
from .free_fermion import TAU_CUTOFF, green_derive_tower, green_kernel
from .hubbard_atom import (HubbardSigma, build_sigma_evaluator, exact_sigma, sigma_mc,
                           sigma_power_series)
from .yukawa import interaction_derive, yukawa_interaction
