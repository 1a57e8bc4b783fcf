"""Monte-Carlo throughput protocol of the port.

Port of ``benchmarks/_mc_bench.py::mc_samples_per_s``: each pass samples
``varK`` (normal) and ``varT`` (uniform in [0, beta)) on the device from a
seeded ``torch.Generator``, evaluates the roots and accumulates their sum
over the batch.  One warm-up run of ``iters`` passes, then the median
wall-clock time of ``reps`` runs, each ended by a device synchronisation.
The sampling runs in the profiler scope ``prng`` and the sum in ``accum``
(``utils.profiling.scope``).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from .utils.profiling import scope


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mc_run(eval_fn: Callable, *, n_loop: int, num_tau: int, batch: int,
           n_roots: int, device, dtype, iters: int, beta: float,
           seed: int) -> torch.Tensor:
    """``iters`` sample-and-evaluate passes; returns the roots' sums [R]."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    acc = torch.zeros(n_roots, dtype=dtype, device=device)
    for _ in range(iters):
        with scope("prng"):
            vk = torch.randn((3, n_loop, batch), generator=gen, dtype=dtype, device=device)
            vt = torch.rand((num_tau, batch), generator=gen, dtype=dtype, device=device) * beta
        roots = eval_fn(vk, vt)
        with scope("accum"):
            acc += roots.sum(dim=1)
    return acc


def mc_samples_per_s(eval_fn: Callable, *, n_loop: int, num_tau: int, batch: int,
                     n_roots: int, device, dtype, iters: int = 200, reps: int = 3,
                     beta: float = 0.5) -> float:
    """Measure samples/s of ``eval_fn(varK, varT) -> roots[R, batch]``."""
    device = torch.device(device)
    kw = dict(n_loop=n_loop, num_tau=num_tau, batch=batch, n_roots=n_roots,
              device=device, dtype=dtype, iters=iters, beta=beta)
    _sync(device)
    mc_run(eval_fn, seed=0, **kw)                          # warm-up
    _sync(device)
    times = []
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        mc_run(eval_fn, seed=r, **kw)
        _sync(device)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    return batch * iters / dt
