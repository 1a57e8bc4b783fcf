"""The median host milliseconds of the program's eager entry in the traced
calls: the program's own span ``call`` (``CompiledEvaluator.__call__``, a
``record_function`` under the profiler), from its start to its return.
A trace with no such span, or not one a traced call, reads nothing."""
import statistics


def read(facts):
    trace = facts.trace
    if trace is None or facts.kind != "call":
        return None
    spans = [end - start for name, start, end in trace.host if name == "call"]
    if not spans or len(spans) != facts.trace_units:
        return None
    return 1e3 * statistics.median(spans)
