"""Closed-loop calls of the program's default entry, the eager
``CompiledEvaluator.__call__``, by one caller on the host, as an
integrator such as Vegas or a Markov chain calls the compiled function.

Set-up draws a pool of ``pool`` batches of ``batch`` samples on the host
(float32, pageable) from ``--seed``.  The window's call ``i`` hands the
program batch ``i mod pool`` and reads all the roots back to the host
before the next call starts.  A call is timed from handing the samples
over to the roots being on the host; its dispatch time, up to the return
of the entry before the read-back waits, is kept apart.  The roots are
read back into the caller's own host array of that batch, allocated (and
touched) at set-up, as an integrator keeps its arrays; so the answers kept
are the last call's roots of each batch of the pool.

Traffic keys: ``batch``, ``pool``, ``trace_calls``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

WARM_CALLS = 3


class Traffic:
    name = "call"

    def __init__(self, compiled, series, traffic: dict, seed: int, device, dtype):
        self.compiled, self.traffic, self.device = compiled, traffic, device
        batch, n_pool = int(traffic["batch"]), int(traffic["pool"])
        rng = np.random.default_rng(seed)
        self.sample_bytes = (3 * series.n_loop + series.n_tau) * 4   # float32 varK and varT
        self.pool = []
        for _ in range(n_pool):
            vk = rng.standard_normal((3, series.n_loop, batch), dtype=np.float32)
            vt = rng.random((series.n_tau, batch), dtype=np.float32) * np.float32(series.beta)
            self.pool.append((torch.from_numpy(vk), torch.from_numpy(vt)))
        self.kept = [compiled(*self.pool[i]).cpu() for i in range(n_pool)]
        self.called = [False] * n_pool
        for i in range(WARM_CALLS):
            self.call(i)

    def call(self, i: int):
        """Call ``i``: its batch handed over, its roots read back into that
        batch's host array; the host clock at the start, at the entry's
        return and at the end."""
        j = i % len(self.pool)
        vk, vt = self.pool[j]
        a = time.perf_counter()
        roots = self.compiled(vk, vt)
        b = time.perf_counter()
        self.kept[j].copy_(roots)
        return a, b, time.perf_counter()

    def window(self, seconds: float) -> dict:
        call_ms, dispatch_ms = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(call_ms)
            a, b, c = self.call(i)
            self.called[i % len(self.pool)] = True
            call_ms.append(1e3 * (c - a))
            dispatch_ms.append(1e3 * (b - a))
        return {"window_s": time.perf_counter() - t0, "attempted": len(call_ms),
                "call_ms": call_ms, "dispatch_ms": dispatch_ms}

    def trace_work(self):
        n = int(self.traffic["trace_calls"])
        return (lambda: [self.call(i) for i in range(n)]), n

    def release(self) -> None:
        self.compiled = None

    def check(self, reference) -> dict:
        """``root_err``: over every kept answer, the largest gap between a
        root's value and the reference's, over the largest magnitude of that
        root in the batch."""
        worst = 0.0
        for (vk, vt), got, called in zip(self.pool, self.kept, self.called):
            if not called:
                continue
            want = reference(vk.to(self.device), vt.to(self.device)).cpu()
            scale = want.abs().amax(dim=1).clamp_min(torch.finfo(torch.float64).tiny)
            gap = (got.double() - want).abs().amax(dim=1) / scale
            worst = max(worst, float(gap.max()))
        return {"root_err": worst}
