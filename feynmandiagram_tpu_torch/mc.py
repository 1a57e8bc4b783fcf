"""Monte-Carlo throughput protocol of the port.

Port of ``benchmarks/_mc_bench.py::mc_samples_per_s``: each pass samples
``varK`` (normal) and ``varT`` (uniform in [0, beta)) on the device from a
seeded ``torch.Generator``, evaluates the roots and accumulates their sum
over the batch.  One warm-up run of ``iters`` passes, then the median
wall-clock time of ``reps`` runs, each ended by a device synchronisation.
The sampling runs in the profiler scope ``prng`` and the sum in ``accum``
(``utils.profiling.scope``).

``jit=True`` is the counterpart of the reference's ``jax.jit`` of the whole
loop: one iteration (the draws into static ``varK`` / ``varT`` from the
run's generator, registered with the graph; the ``CompiledEvaluator``'s
static pass; the sum into a static accumulator) is captured as one CUDA
graph and replayed ``iters`` times.  A replay draws from the generator's
state at replay time, as an eager iteration does.  ``CapturedLoop.run``
runs in the scope ``mc.chunk``, each replay in its graph's
(``ops.graphs.replay``).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from .ops.graphs import capture, replay, require_cuda
from .utils.profiling import scope


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CapturedLoop:
    """``mc_run``'s iteration captured as one CUDA graph, for one
    ``CompiledEvaluator`` and one set of ``mc_run``'s sizes; ``run(seed,
    iters)`` replays it.  ``varK`` and ``varT`` are the static draws of the
    last replay."""

    def __init__(self, compiled, *, n_loop: int, num_tau: int, batch: int, n_roots: int,
                 device, dtype, beta: float):
        from .backends.compile import CompiledEvaluator
        device = torch.device(device)
        require_cuda(device, "mc_run")
        if not isinstance(compiled, CompiledEvaluator):
            raise ValueError(f"mc_run(jit=True) captures a CompiledEvaluator's static pass; "
                             f"got {type(compiled).__name__}, which it cannot capture")
        self.gen = torch.Generator(device=device)
        self.varK = torch.empty((3, n_loop, batch), dtype=dtype, device=device)
        self.varT = torch.empty((num_tau, batch), dtype=dtype, device=device)
        self.acc = torch.zeros(n_roots, dtype=dtype, device=device)
        body = compiled.static_pass(batch)

        def step() -> torch.Tensor:
            # normal_ and uniform_ are what torch.randn and torch.rand run
            self.varK.normal_(generator=self.gen)
            self.varT.uniform_(generator=self.gen).mul_(beta)
            self.acc += body(self.varK, self.varT).sum(dim=1)
            return self.acc

        self.graph, _ = capture(step, generators=(self.gen,))

    def run(self, seed: int, iters: int) -> torch.Tensor:
        """``iters`` replays from the generator seeded with ``seed``; a
        fresh tensor of the roots' sums [R]."""
        with scope("mc.chunk"):
            self.gen.manual_seed(seed)
            self.acc.zero_()
            replay(self.graph, iters)
            return self.acc.clone()


def mc_run(eval_fn: Callable, *, n_loop: int, num_tau: int, batch: int,
           n_roots: int, device, dtype, iters: int, beta: float,
           seed: int, jit: bool = False) -> torch.Tensor:
    """``iters`` sample-and-evaluate passes; returns the roots' sums [R].

    ``jit=True`` captures one pass (``CapturedLoop``) and replays it; it
    needs a CUDA ``device`` and a ``CompiledEvaluator`` as ``eval_fn``
    (``ValueError`` otherwise: a captured ``fn`` cannot be captured again).
    """
    device = torch.device(device)
    if jit:
        return CapturedLoop(eval_fn, n_loop=n_loop, num_tau=num_tau, batch=batch,
                            n_roots=n_roots, device=device, dtype=dtype,
                            beta=beta).run(seed, iters)
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
                     beta: float = 0.5, jit: bool = False) -> float:
    """Measure samples/s of ``eval_fn(varK, varT) -> roots[R, batch]``.

    ``jit=True`` captures the pass once, before the warm-up run, and times
    replays (``mc_run``'s conditions)."""
    device = torch.device(device)
    kw = dict(n_loop=n_loop, num_tau=num_tau, batch=batch, n_roots=n_roots,
              device=device, dtype=dtype, beta=beta)
    if jit:
        run = CapturedLoop(eval_fn, **kw).run
    else:
        def run(seed, iters):
            return mc_run(eval_fn, seed=seed, iters=iters, **kw)
    _sync(device)
    run(0, iters)                                          # warm-up
    _sync(device)
    times = []
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        run(r, iters)
        _sync(device)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    return batch * iters / dt
