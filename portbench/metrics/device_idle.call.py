"""The device's idle share of the traced calls, in %: 1 - the union of its
kernels', copies' and fills' intervals over the traced window's wall."""
from portbench.metrics import _kernels


def read(facts):
    return _kernels.idle_percent(facts, "call")
