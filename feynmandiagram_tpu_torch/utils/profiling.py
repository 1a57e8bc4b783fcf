"""Profiling hooks of the port.

Port of ``feynmandiagram_tpu/utils/profiling.py``.  ``trace`` wraps
``torch.profiler`` as the JAX package's wraps ``jax.profiler``;
``lowered_cost`` is the same op-count cost model of a lowered graph.
``scope`` names a span of the hot path for the profiler, as the JAX
package's ``jax.named_scope`` does, and costs no dispatch when no profiler
runs and no capture is open.

What the JAX package has no counterpart of, since XLA runs its programs:

- a **launch manifest** for each captured CUDA graph.  A replay runs no
  Python, so nothing counts or names the kernels it launches.  While
  ``capturing`` is open, each launch wrapper's ``launched(kernel)`` keeps
  the kernel's symbol and the path of the scopes it ran in (``leaf``,
  ``gL05/fb8``) in the graph's ``Manifest``, in launch order (a run of
  levels launched from one C call, ``launched_run``, one entry a launch: a
  level's, or a column run's over a stretch of levels, ``gL04-gL298/run``);
  ``replayed(manifest, n)`` then adds ``n`` replays' launches to the
  wrappers' ``launches`` counters, which so count every launch the device
  runs, eager or replayed.  ``manifest(name)`` returns a live graph's
  manifest by its name, which the graph's replays carry in their scope
  ``replay:<name>``;
- **set-up phases**: ``phase(name)`` times the front end, ``optimize_inplace``,
  ``taylorAD`` and ``compile_evaluator`` on ``time.perf_counter``, always
  (a few dozen records a build, none in a pass), and is a ``record_function``
  span too while a profiler runs; ``phases()`` returns the records;
  ``count(name)`` adds to a set-up counter, ``counters()`` returns them.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()
# the most set-up phases kept: the newest, a few dozen a build
PHASES_KEPT = 1024

_recording: Optional["Manifest"] = None     # the manifest of the open capture
_path: List[str] = []                       # the scopes open in the capture
_manifests: "weakref.WeakValueDictionary[str, Manifest]" = weakref.WeakValueDictionary()
_graph_ids = itertools.count()


class _Tracked:
    """A scope entered while a capture is open: its name joins the path
    that ``launched`` records, and it is a ``record_function`` span too
    where a profiler runs."""
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name
        self.span = record_function(name) if _autograd_profiler._is_profiler_enabled else _OFF

    def __enter__(self):
        _path.append(self.name)
        self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        _path.pop()


def scope(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs, and
    otherwise a context that does nothing: an unprofiled pass enters no
    span, since each costs a dispatched op even with no profiler.  While a
    capture is open (``capturing``) the scope also names the launches inside
    it in the graph's manifest."""
    if _recording is not None:
        return _Tracked(name)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


@dataclass(frozen=True)
class Launch:
    """One kernel launch a captured graph holds: the kernel's ``symbol`` as
    the device's records name it, the ``path`` of the scopes it ran in,
    outermost first, the launch wrapper (``kernel``) that counts it, and
    the ``levels`` of a pass that it computes (more than one for a column
    run)."""
    symbol: str
    path: str
    kernel: Callable
    levels: int = 1


class Manifest(list):
    """The launches of one captured graph, in launch order (``Launch``).
    ``name`` is the graph's, ``span`` the scope its replays run in."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.span = f"replay:{name}"
        self.per_kernel: Dict[Callable, int] = {}
        self.levels_per_kernel: Dict[Callable, int] = {}


def launched(kernel: Callable) -> None:
    """Count one launch of ``kernel``, a launch wrapper with the attributes
    ``launches`` (its count) and ``symbol`` (its kernel's name).  While a
    capture is open the launch runs on no device yet: it is kept in the
    graph's manifest instead, and counted by each replay (``replayed``)."""
    if _recording is None:
        kernel.launches += 1
    else:
        _recording.append(Launch(kernel.symbol, "/".join(_path), kernel))


def launched_run(launcher: Callable, launches, counts) -> None:
    """Count one call of ``launcher``, which issued ``launches`` in order,
    each ``(kernel, path, levels)``: a launch of the wrapper ``kernel`` that
    computed ``levels`` levels of a pass (a run of levels: ``gL05/fb8``, ...,
    a column run ``gL04-gL298/run``).  Outside a capture ``launcher.calls``
    grows by one and each of ``counts``, ``(owner, attribute, n)``, the
    launcher's and the kernels' counters, by its ``n``.  In a capture each
    launch joins the graph's manifest as ``launched`` keeps it, its path
    under the scopes open there (an empty path: theirs alone)."""
    if _recording is None:
        launcher.calls += 1
        for owner, name, n in counts:
            setattr(owner, name, getattr(owner, name) + n)
    else:
        _recording.extend(Launch(kernel.symbol, "/".join(_path + [path] if path else _path),
                                 kernel, levels) for kernel, path, levels in launches)


@contextlib.contextmanager
def capturing():
    """Open a capture: yield the ``Manifest`` of a new graph name, which
    the launches until the block ends fill (``launched``).  The manifest is
    then found by its name (``manifest``) as long as it lives; a graph
    keeps it as ``graph.manifest``.  One capture is open at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError(f"capture {_recording.name} is still open")
    m = Manifest(f"g{next(_graph_ids)}")
    _recording = m
    _path.clear()
    try:
        yield m
    finally:
        _recording = None
        _path.clear()
    m.per_kernel = dict(collections.Counter(launch.kernel for launch in m))
    levels = collections.Counter()
    for launch in m:
        if hasattr(launch.kernel, "levels"):
            levels[launch.kernel] += launch.levels
    m.levels_per_kernel = dict(levels)
    _manifests[m.name] = m


def replayed(m: Optional[Manifest], n: int = 1) -> None:
    """Add ``n`` replays of the graph of manifest ``m`` (none: a graph that
    kept none) to its kernels' launch counters, and to the ``levels`` of a
    kernel that counts the levels its launches computed."""
    if m is not None:
        for kernel, count in m.per_kernel.items():
            kernel.launches += count * n
        for kernel, levels in m.levels_per_kernel.items():
            kernel.levels += levels * n


def manifest(name: str) -> Optional[Manifest]:
    """The manifest of the live graph named ``name``, or ``None``."""
    return _manifests.get(name)


class Phase(NamedTuple):
    """A set-up phase: its name, the name of the phase it ran in (``None``
    at the top), and its start and end on ``time.perf_counter``."""
    name: str
    parent: Optional[str]
    start: float
    end: float


_phases: "collections.deque[Phase]" = collections.deque(maxlen=PHASES_KEPT)
_open_phases = threading.local()


@contextlib.contextmanager
def phase(name: str):
    """Time a set-up phase named ``name`` into ``phases()``; a
    ``record_function`` span too while a profiler runs.  A phase inside an
    open phase of the same name (a recursive call) is not recorded again."""
    stack = getattr(_open_phases, "names", None)
    if stack is None:
        stack = _open_phases.names = []
    if name in stack:
        yield
        return
    parent = stack[-1] if stack else None
    stack.append(name)
    span = record_function(name) if _autograd_profiler._is_profiler_enabled else _OFF
    start = time.perf_counter()
    try:
        with span:
            yield
    finally:
        _phases.append(Phase(name, parent, start, time.perf_counter()))
        stack.pop()


def phased(name: str):
    """Decorate a function to run as the set-up phase ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def phases() -> List[Phase]:
    """The recorded set-up phases of this process, oldest first (the newest
    ``PHASES_KEPT``); each is recorded when it ends."""
    return list(_phases)


_counts: "collections.Counter[str]" = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the set-up counter ``name`` (what a build made, such as
    ``diagsGV_series.partitions``); ``counters()`` returns them."""
    _counts[name] += n


def counters() -> Dict[str, int]:
    """The set-up counters of this process (``count``), by name."""
    return dict(_counts)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "fdtpu_trace")):
    """Profile a code block on the host and, where there is a card, on the
    card; yield the profiler, and write its Chrome trace into ``log_dir``
    as ``trace_<ns>.json`` when the block ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def lowered_cost(lowered, batch: int = 1) -> Dict[str, float]:
    """Cost model of a LoweredGraph: edge ops, FLOPs and bytes per batch.

    The JAX package's model (4 bytes and 2 FLOP an edge), kept for parity
    with its ``utils``; the benchmark prices the kernels by
    ``portbench/counting.py`` instead."""
    edges = lowered.num_edges
    flops = 2.0 * edges * batch
    bytes_accessed = 4.0 * (2 * edges + lowered.num_slots) * batch
    return {
        "num_slots": lowered.num_slots,
        "num_levels": lowered.num_levels,
        "num_edges": edges,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": flops / bytes_accessed,
    }
