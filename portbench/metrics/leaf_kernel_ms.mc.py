"""Device milliseconds a pass of the leaf kernel (``leaf_eval_kernel`` by
name) in the traced Monte-Carlo passes."""
from portbench.metrics import _kernels


def read(facts):
    return _kernels.ms_per_unit(facts, "mc", _kernels.LEAF)
