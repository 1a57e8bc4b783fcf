"""The median host time of a call before it waits for the read-back: from
handing the samples over to the entry's return (host clock)."""
import statistics


def read(facts):
    calls = facts.window.get("dispatch_ms")
    return statistics.median(calls) if calls else None
