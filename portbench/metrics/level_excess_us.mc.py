"""The level kernel's device microseconds over its level's own bound, per
(traced pass, level): the median over all pairs.

The program keeps a launch manifest of the captured pass (its
``utils.profiling``), found by the name its traced replays carry in the
scope ``replay:<name>``: the pass's kernel launches in order, each with the
scopes it ran in (``gL05/fb8``).  Its level launches label the trace's
``gather_reduce_kernel`` records in order, pass after pass; each record's
time less the bound of its level (``counting.level_bounds``: its distinct
rows read and rows written once at 3.35 TB/s, or its multiply-adds at 67
TFLOP/s) is one pair's excess.  No manifest, levels other than the
lowering's kernel levels, or records other than the traced passes times the
manifest's level launches: nothing is read."""
import re
import statistics

from portbench import counting
from portbench.metrics import _kernels

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
    bounds = [b["s"] for b in counting.level_bounds(facts.lowered, facts.batch,
                                                    facts.store_bytes)]
    records = sorted((a, b) for name, a, b in trace.ops if _kernels.LEVEL in name)
    if len(records) != facts.trace_units * len(levels):
        return None
    return statistics.median(1e6 * (b - a - bounds[k % len(levels)])
                             for k, (a, b) in enumerate(records))
