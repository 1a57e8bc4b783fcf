"""The device's idle microseconds between consecutive replays of the
captured pass in the traced passes: the median over the N - 1 gaps, each
from the end of the last operation of replay k to the start of the first
of replay k + 1.

The traced device operations (kernels, copies, fills; in order of start)
are cut into the N replays by the program's launch manifest (its
``utils.profiling``, found by the name the replays carry in the scope
``replay:<name>``): the records of the manifest's kernels must be N times
its launches, each replay's at the same positions, and exactly one cut of
N periods of that length must give N replays of the same operations, in
the same order (what comes before the first and after the last replay, the
chunk's zeroing and read-out, does not repeat).  Anything else reads
nothing."""
import statistics

REPLAY = "replay:"


def manifest(trace):
    """The program's launch manifest of the one graph whose replays the
    trace holds, or ``None``."""
    names = {name[len(REPLAY):] for name, _, _ in trace.host if name.startswith(REPLAY)}
    if len(names) != 1:
        return None
    from feynmandiagram_tpu_torch.utils import profiling

    find = getattr(profiling, "manifest", None)
    return find(names.pop()) if find is not None else None


def replays(ops, symbols, n):
    """The ``n`` replays of ``ops`` (name, start, end) in order of start, as
    lists, where the manifest's kernel ``symbols`` mark them out as one
    unique cut; else ``None``."""
    m = len(symbols)
    marks = [i for i, (name, _, _) in enumerate(ops) if any(s in name for s in symbols)]
    if n < 2 or m == 0 or len(marks) != n * m:
        return None
    if any(symbols[k % m] not in ops[i][0] for k, i in enumerate(marks)):
        return None
    period = marks[m] - marks[0]
    if any(marks[k] != marks[k % m] + (k // m) * period for k in range(n * m)):
        return None
    names = [name for name, _, _ in ops]
    cuts = [s for s in range(max(0, marks[m - 1] - period + 1), marks[0] + 1)
            if s + n * period <= len(ops)
            and all(names[s + k * period:s + (k + 1) * period] == names[s:s + period]
                    for k in range(1, n))]
    if len(cuts) != 1:
        return None
    s = cuts[0]
    return [ops[s + k * period:s + (k + 1) * period] for k in range(n)]


def read(facts):
    trace = facts.trace
    if trace is None or facts.kind != "mc":
        return None
    m = manifest(trace)
    if m is None:
        return None
    cut = replays(sorted(trace.ops, key=lambda op: op[1]), [x.symbol for x in m],
                  facts.trace_units)
    if cut is None:
        return None
    return statistics.median(1e6 * (nxt[0][1] - max(end for _, _, end in cur))
                             for cur, nxt in zip(cut, cut[1:]))
