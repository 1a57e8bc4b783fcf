"""Device milliseconds a pass of the small levels: the level kernel's
records (``gather_reduce_kernel``) of the levels whose own bound
(``counting.level_bounds`` at the cell's batch: distinct rows read and rows
written once at 3.35 TB/s, or the multiply-adds at 67 TFLOP/s) is under
``SMALL_US`` microseconds, summed over the traced passes and divided by
their number.  Such a level takes about a launch's fixed cost whatever its
size, so this is the part of a pass that a cheaper launch would shorten.

The records are labelled by the program's launch manifest of the captured
pass (its ``utils.profiling``, found by the name its traced replays carry
in the scope ``replay:<name>``), in order, pass after pass, as
``level_excess_us.mc`` labels them.  No manifest, levels other than the
lowering's kernel levels, records other than the traced passes times the
manifest's level launches, or no small level: nothing is read."""
import re

from portbench import counting
from portbench.metrics import _kernels

SMALL_US = 10.0
REPLAY = "replay:"
LEVEL_SCOPE = re.compile(r"gL(\d+)(?:/|$)")


def manifest(trace):
    """The program's launch manifest of the one graph whose replays the
    trace holds, or ``None``."""
    names = {name[len(REPLAY):] for name, _, _ in trace.host if name.startswith(REPLAY)}
    if len(names) != 1:
        return None
    from feynmandiagram_tpu_torch.utils import profiling

    find = getattr(profiling, "manifest", None)
    return find(names.pop()) if find is not None else None


def read(facts):
    trace = facts.trace
    if trace is None or facts.kind != "mc" or facts.trace_units < 1:
        return None
    m = manifest(trace)
    if m is None:
        return None
    levels = []
    for launch in m:
        if launch.symbol == _kernels.LEVEL:
            tag = LEVEL_SCOPE.match(launch.path)
            if tag is None:
                return None
            levels.append(int(tag.group(1)))
    kernel_levels = [i for i, level in enumerate(facts.lowered.levels)
                     if counting.level_groups(level)]
    if not levels or levels != kernel_levels:
        return None
    small = [b["s"] < SMALL_US * 1e-6
             for b in counting.level_bounds(facts.lowered, facts.batch, facts.store_bytes)]
    records = sorted((a, b) for name, a, b in trace.ops if _kernels.LEVEL in name)
    if not any(small) or len(records) != facts.trace_units * len(levels):
        return None
    return 1e3 * sum(b - a for k, (a, b) in enumerate(records)
                     if small[k % len(levels)]) / facts.trace_units
