"""The level kernel's share of its roofline, in %: the sum over levels of
``counting.level_bounds`` (each level's distinct rows read and rows
written once at 3.35 TB/s, or its multiply-adds at 67 TFLOP/s) over its
device time a pass."""
from portbench import counting
from portbench.metrics import _kernels


def read(facts):
    ms = _kernels.ms_per_unit(facts, "mc", _kernels.LEVEL)
    if not ms:
        return None
    bound = sum(b["s"] for b in counting.level_bounds(facts.lowered, facts.batch,
                                                      facts.store_bytes))
    return 100.0 * 1e3 * bound / ms
