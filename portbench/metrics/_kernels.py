"""What the kernel readers share: the kernels' names, and their time and the
idle share in a trace of the right kind of traffic."""

LEAF = "leaf_eval_kernel"
LEVEL = "gather_reduce_kernel"


def ms_per_unit(facts, kind: str, kernel: str):
    """Device ms a traced unit (pass or call) of the kernels whose name
    holds ``kernel``; ``None`` where the trace holds none of them."""
    trace = facts.trace
    if trace is None or facts.kind != kind:
        return None

    def match(name):
        return kernel in name

    if not trace.count_of(match):
        return None
    return 1e3 * trace.seconds_of(match) / facts.trace_units


def idle_percent(facts, kind: str):
    trace = facts.trace
    if trace is None or facts.kind != kind or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
