"""The 95th percentile of every call's time in the window, from handing the
samples over to the roots being on the host (host clock)."""
import numpy as np


def read(facts):
    calls = facts.window.get("call_ms")
    return float(np.percentile(calls, 95)) if calls else None
