"""The leaf kernel's share of its roofline, in %: ``counting.leaf_bound``
(its samples read and leaves written once at 3.35 TB/s, or the float64
operations the leaf tables need at 34 TFLOP/s, whichever is longer) over
its device time a pass."""
from portbench import counting
from portbench.metrics import _kernels


def read(facts):
    ms = _kernels.ms_per_unit(facts, "mc", _kernels.LEAF)
    if not ms:
        return None
    bound = counting.leaf_bound(facts.leaf_tables, facts.batch, facts.sample_bytes,
                                facts.store_bytes)
    return 100.0 * 1e3 * bound["s"] / ms
