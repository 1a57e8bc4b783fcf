"""Device milliseconds a pass of the level kernel (``gather_reduce_kernel``
by name, every level) in the traced Monte-Carlo passes."""
from portbench.metrics import _kernels


def read(facts):
    return _kernels.ms_per_unit(facts, "mc", _kernels.LEVEL)
