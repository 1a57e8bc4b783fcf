"""Profiling hooks of the port.

Port of ``feynmandiagram_tpu/utils/profiling.py``.  ``trace`` wraps
``torch.profiler`` as the JAX package's wraps ``jax.profiler``;
``lowered_cost`` is the same op-count cost model of a lowered graph.
``scope`` names a span of the hot path for the profiler, as the JAX
package's ``jax.named_scope`` does, and costs no dispatch when no profiler
runs.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()


def scope(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs, and
    otherwise a context that does nothing: an unprofiled pass enters no
    span, since each costs a dispatched op even with no profiler."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


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
    """Cost model of a LoweredGraph: edge ops, FLOPs and bytes per batch."""
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
