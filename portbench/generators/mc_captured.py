"""The captured Monte-Carlo loop (``mc.CapturedLoop``, what ``mc_run(jit=True)``
runs): one CUDA graph a pass draws ``varK`` and ``varT`` on the device,
evaluates the roots and adds their sum over the batch to the accumulator.

The window calls ``CapturedLoop.run(seed_c, passes)`` chunk after chunk,
each chunk seeded from ``--seed`` and its index, for as long as the window
lasts; the host stays at most ``QUEUED_CHUNKS`` chunks ahead of the device,
so the device never waits for it and the window's end is near its last
chunk.  Each chunk's answer is its sums over ``passes`` x ``batch`` samples.

Traffic keys: ``batch``, ``chunk_passes``, ``check_chunks`` (the chunks
compared with the reference, drawn from the seed), ``trace_passes``.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

QUEUED_CHUNKS = 2
SEED_STRIDE = 1 << 20          # chunks a seed may run before its chunk seeds repeat
WARM_CHUNK, TRACE_CHUNK = SEED_STRIDE - 1, SEED_STRIDE - 2


class Traffic:
    name = "mc"

    def __init__(self, compiled, series, traffic: dict, seed: int, device, dtype):
        from feynmandiagram_tpu_torch.mc import CapturedLoop

        self.batch = int(traffic["batch"])
        self.passes = int(traffic["chunk_passes"])
        self.traffic, self.seed, self.dtype, self.device = traffic, seed, dtype, device
        self.shape_k = (3, series.n_loop, self.batch)
        self.shape_t = (series.n_tau, self.batch)
        self.beta = series.beta
        # a sample column: varK and varT in the storage type
        self.sample_bytes = (3 * series.n_loop + series.n_tau) * torch.empty(
            (), dtype=dtype).element_size()
        self.loop = CapturedLoop(compiled, n_loop=series.n_loop, num_tau=series.n_tau,
                                 batch=self.batch, n_roots=len(compiled.lowered.root_slots),
                                 device=device, dtype=dtype, beta=series.beta)
        self.on_card = torch.device(device).type == "cuda"
        self.loop.run(self.chunk_seed(WARM_CHUNK), self.passes)
        self.sync()
        self.sums = []

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def chunk_seed(self, chunk: int) -> int:
        return (self.seed * SEED_STRIDE + chunk) % (1 << 63)

    def window(self, seconds: float) -> dict:
        self.sync()
        queued = deque()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.sums.append(self.loop.run(self.chunk_seed(len(self.sums)), self.passes))
            if self.on_card:
                done = torch.cuda.Event()
                done.record()
                queued.append(done)
                if len(queued) > QUEUED_CHUNKS:
                    queued.popleft().synchronize()
        self.sync()
        window_s = time.perf_counter() - t0
        n = len(self.sums) * self.passes
        return {"window_s": window_s, "attempted": n, "samples": n * self.batch}

    def trace_work(self):
        """The traced work and the passes it holds."""
        n = int(self.traffic["trace_passes"])
        return (lambda: self.loop.run(self.chunk_seed(TRACE_CHUNK), n)), n

    def release(self) -> None:
        self.sums = [s.double().cpu() for s in self.sums]
        self.loop = None

    def draws(self, chunk: int):
        """The draws of a chunk's passes, made again as the loop makes them:
        one generator seeded with the chunk's seed, then per pass
        ``normal_`` into ``varK`` and ``uniform_`` times beta into ``varT``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.chunk_seed(chunk))
        for _ in range(self.passes):
            vk = torch.empty(self.shape_k, dtype=self.dtype, device=self.device)
            vt = torch.empty(self.shape_t, dtype=self.dtype, device=self.device)
            vk.normal_(generator=gen)
            vt.uniform_(generator=gen).mul_(self.beta)
            yield vk, vt

    def check(self, reference) -> dict:
        """``sum_err``: over the chunks drawn from the seed, the largest gap
        between a root's sum and the reference's, over the sum of the
        reference's magnitudes of that root on the chunk's samples."""
        rng = np.random.default_rng(self.seed)
        n = min(int(self.traffic["check_chunks"]), len(self.sums))
        worst = 0.0
        for chunk in sorted(rng.choice(len(self.sums), size=n, replace=False).tolist()):
            total = scale = 0.0
            for vk, vt in self.draws(chunk):
                roots = reference(vk, vt)
                total = total + roots.sum(dim=1).cpu()
                scale = scale + roots.abs().sum(dim=1).cpu()
            gap = (self.sums[chunk] - total).abs() / scale
            worst = max(worst, float(gap.max()))
        return {"sum_err": worst}
