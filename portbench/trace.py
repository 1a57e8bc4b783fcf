"""A bounded, in-memory profiler trace of the window's own entry, and what
the per-layer readers take from it.

``traced`` runs a function under ``torch.profiler`` (CPU and CUDA
activities): first ``PROFILE_LEAD`` sleep kernels, then, inside a
``record_function`` span named ``WINDOW``, the traced work, ended by a
synchronisation.  On the card the profiler drops a trace's first kernel
records (about 8), so the lead kernels take that loss; they lie before the
span and are left out.  The window is the span's length on the host
clock; device work is every CUDA record inside it that is no annotation:
kernels, copies and fills.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

PROFILE_LEAD = 64
WINDOW = "portbench.window"
BREAKDOWN_ENTRIES = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::k<float, 4>(float*)``
    reads ``k``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip() or name[:64]


def union_length(intervals) -> float:
    """The length of the union of intervals (start, end): the time in which
    at least one of them runs."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of (lo, hi) that no interval covers."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """The device work inside the window: ``ops`` (name, start, end) in
    seconds from the window's start, ``window_s`` the window's length, and
    ``host`` (name, start, end) the host's own records inside it."""
    window_s: float
    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_length((a, b) for _, a, b in self.ops)

    def seconds_of(self, match: Callable[[str], bool]) -> float:
        """The summed device time of the operations whose name matches."""
        return sum(b - a for name, a, b in self.ops if match(name))

    def count_of(self, match: Callable[[str], bool]) -> int:
        return sum(1 for name, _, _ in self.ops if match(name))

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time (by ``short_name``), and
        the device's idle time by what the host was doing then (the innermost
        host record at each gap's middle), at most ``BREAKDOWN_ENTRIES`` of
        each."""
        by_op: Dict[str, float] = {}
        for name, a, b in self.ops:
            name = short_name(name)
            by_op[name] = by_op.get(name, 0.0) + (b - a)
        by_host: Dict[str, float] = {}
        for a, b in gaps([(s, e) for _, s, e in self.ops], 0.0, self.window_s):
            mid = (a + b) / 2
            inside = [(s, name) for name, s, e in self.host if s <= mid <= e]
            label = max(inside)[1] if inside else "no host record"
            by_host[label] = by_host.get(label, 0.0) + (b - a)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][
                :BREAKDOWN_ENTRIES]

        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def traced(work: Callable[[], None]) -> Trace:
    """Run ``work`` once under the profiler, led by ``PROFILE_LEAD`` sleep
    kernels, and return its ``Trace``.  ``work`` must leave its device work
    queued or done; the span ends with a synchronisation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.01)
        with record_function(WINDOW):
            work()
            torch.cuda.synchronize()
    events = prof.events()
    spans = [e for e in events if e.name == WINDOW and not str(e.device_type).endswith("CUDA")]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} host spans {WINDOW!r}, not one")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    ops, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if a < w0 or a > w1 or e is spans[0]:
            continue
        if str(e.device_type).endswith("CUDA"):
            if not e.is_user_annotation:
                ops.append((e.name, (a - w0) / 1e6, (min(b, w1) - w0) / 1e6))
        else:
            host.append((e.name, (a - w0) / 1e6, (b - w0) / 1e6))
    return Trace((w1 - w0) / 1e6, ops, host)
