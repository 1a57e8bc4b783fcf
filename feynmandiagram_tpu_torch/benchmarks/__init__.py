"""Benchmarks and probes of the port on one GPU, counterparts of the JAX
package's ``benchmarks/`` scripts of the same names (``probe_mosaic_caps``,
``probe_gather``, ``probe_bucket_fusion``, ``bench_config4``,
``certify_sharded``, ``scan_merge``, ``probe_structure``, ``probe_split``,
``scaling``), and the port's own
(``profile_pass``, ``gamma4_orders``, ``slice_error``).

Each runs as ``python -m feynmandiagram_tpu_torch.benchmarks.<name>`` on a
machine with a CUDA card and exits non-zero without one, unless it is given
``--device cpu`` where it takes one (``gamma4_orders`` is host work alone).
The helpers here time on the card and name it.
"""
from __future__ import annotations

import statistics
import subprocess
from typing import Callable


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


ITERS, WARMUP = 20, 3


def median_ms(fn: Callable[[], object]) -> float:
    """Median over ``ITERS`` calls of the time between CUDA events recorded
    just before and just after one call of ``fn``, after ``WARMUP`` calls.
    Each call starts on an idle stream, so a call that is shorter than its
    own host-side launch work measures that work."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def events_ms(fn: Callable[..., object], *args, iters: int = 20) -> float:
    """Mean ms a call of ``fn(*args)`` between two CUDA events around
    ``iters`` calls back to back, after one warm-up call."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


QUEUED_REPS = 5


def queued_ms(fn: Callable[[], object], reps: int = QUEUED_REPS) -> float:
    """Device ms of one call of ``fn`` with the host out of the way: the
    call is enqueued between two CUDA events behind a sleep kernel, which
    is lengthened until the first event is still pending when the host is
    done, so that the device never waits for the host.  The median of
    ``reps`` such runs, after one warm-up call; ``fn`` must not wait for the
    device.  ``chip_smoke.py``'s ``queued_ms``, for one call."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles, runs = 10 ** 7, []
    while len(runs) < reps:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        starved = e0.query()
        torch.cuda.synchronize()
        if not starved:
            runs.append(e0.elapsed_time(e1))
        elif cycles < 2 ** 32:
            cycles *= 2
        else:
            raise RuntimeError("the host did not enqueue the call within a sleep of 2^32 "
                               "cycles: it waits for the device")
    return statistics.median(runs)
