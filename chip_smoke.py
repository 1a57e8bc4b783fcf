#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the order-4 Gamma4 Monte-Carlo evaluation,
on the card and checks it.  Phases, one output line or more each:

1. the card's name and power limit (nvidia-smi);
2. the build of the CUDA kernel from ``feynmandiagram_tpu_torch/csrc``;
3. the kernel against its plain PyTorch version on the card, on random
   buckets (n_op 1-4, float32 and float64, Kahan on and off) and on every
   bucket of the order-4 fused and bucketed lowerings at batch 256;
4. the slice: order-4 Gamma4 -> optimize -> ``compile_evaluator`` on cuda in
   float32 for sum_mode 'fused' and 'bucketed', against the port's plain
   path in float64 on the card, with the kernel's launch count per pass;
5. per-pass device and wall times of the kernel and of the plain version,
   Monte-Carlo samples/s of both slices and the device's idle share.

Then one JSON line on the kernels, and the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, and so
does a machine without CUDA: nothing runs on the CPU instead.  jax is
blocked from import; the port reaches only the jax-free host modules of
``feynmandiagram_tpu``.
"""
import json
import os
import subprocess
import sys
import time

SEED = 0
BATCH = 4096
CHECK_BATCH = 256
BETA, KF, LAM = 0.5, 1.919, 1.0
RTOL = {"float32": 1e-5, "float64": 1e-12}
SLICE_TOL = 1e-5   # max|f32 kernel - f64 plain| / max|f64 plain|, per root


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    sys.modules["jax"] = None   # the port must not need jax
    import numpy as np
    from feynmandiagram_tpu_torch import _host as h
    from feynmandiagram_tpu_torch.backends import compile_evaluator
    from feynmandiagram_tpu_torch.mc import mc_run, mc_samples_per_s
    from feynmandiagram_tpu_torch.ops import kernels
    from feynmandiagram_tpu_torch.ops.evaluator import make_evaluator
    from feynmandiagram_tpu_torch.ops.leaf_eval import make_leaf_evaluator

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_fn, plain_fn = kernels.bucket_gather_reduce, kernels.bucket_gather_reduce_plain

    # -- 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)

    # -- 2. build
    t0 = time.perf_counter()
    kernels.build()
    print(f"build: bucket_gather_reduce built in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. kernel against plain version
    def check_bucket(w, idx, fac, start, compensated, label):
        """Run kernel and plain version on copies of w; return max|diff|.
        Bound: |diff| <= rtol * sum_a |fac * prod_k w| (the terms' size)."""
        count = idx.shape[2]
        wk, wp = w.clone(), w.clone()
        kernel_fn(wk, idx, fac, start, compensated=compensated)
        plain_fn(wp, idx, fac, start, compensated=compensated)
        wm = w.abs().double()
        plain_fn(wm, idx, fac.abs().double(), start)
        torch.cuda.synchronize()
        rows = slice(start, start + count)
        diff = (wk[rows].double() - wp[rows].double()).abs()
        bound = RTOL[str(w.dtype).split(".")[1]] * wm[rows]
        if not torch.isfinite(wk[rows]).all() or bool((diff > bound).any()):
            fail(f"kernel != plain on {label}: max|diff| {diff.max().item():.3e}")
        if not torch.equal(wk[:start], w[:start]) or not torch.equal(wk[start + count:],
                                                                     w[start + count:]):
            fail(f"kernel wrote outside its rows on {label}")
        return diff.max().item()

    gen = np.random.default_rng(SEED)

    def rand_case(S, B, A, C, n_op, dtype):
        w = torch.as_tensor(gen.uniform(0.5, 1.5, (S + C, B)), dtype=dtype, device=dev)
        idx = torch.as_tensor(gen.integers(0, S, (n_op, A, C)), dtype=torch.int32, device=dev)
        fac = torch.as_tensor(gen.choice([1.0, -1.0, 0.5, -2.0], (A, C)), dtype=dtype,
                              device=dev)
        return w, idx, fac, S

    err = check_bucket(*rand_case(16, 128, 2, 8, 1, torch.float32), False,
                       "Pallas test shape S=16 B=128 A=2 C=8")
    print(f"kernel: Pallas test shape S=16 B=128 A=2 C=8 f32: max|diff| {err:.3e}", flush=True)
    for dtype in (torch.float32, torch.float64):
        for n_op in (1, 2, 3, 4):
            for comp in (False, True):
                label = f"random n_op={n_op} {dtype} compensated={comp}"
                err = check_bucket(*rand_case(64, 300, 16, 40, n_op, dtype), comp, label)
                print(f"kernel: {label}: max|diff| {err:.3e}", flush=True)

    t0 = time.perf_counter()
    para = h.DiagPara(type=h.Ver4Diag, innerLoopNum=4, hasTau=True,
                      filter=(h.NoHartree,),
                      interaction=(h.Interaction(h.ChargeCharge, h.Instant),))
    roots = [row["diagram"] for row in h.vertex4(para)]
    h.optimize_inplace(roots, level=1)
    print(f"host: order-4 Gamma4 generated and optimized in {time.perf_counter() - t0:.1f} s "
          f"({len(roots)} roots)", flush=True)
    compiled = {}
    for mode in ("fused", "bucketed"):
        t0 = time.perf_counter()
        compiled[mode] = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                                           kF=KF, lam=LAM, device=dev, dtype=torch.float32,
                                           sum_mode=mode)
        low = compiled[mode].lowered
        print(f"host: {mode} lowering in {time.perf_counter() - t0:.1f} s: {low.num_slots} "
              f"slots, {low.num_edges} edges, {len(low.levels)} levels", flush=True)

    def buckets_of(low):
        out = []
        for lvl in low.levels:
            out += [(np.asarray(sb.idx)[None], sb.fac, sb.start) for sb in lvl.sum_buckets]
            out += [(fb.idx, fb.fac, fb.start) for fb in lvl.fused]
        return out

    main_err = 0.0
    for mode in ("fused", "bucketed"):
        low = compiled[mode].lowered
        w = torch.as_tensor(gen.uniform(0.5, 1.5, (low.num_slots, CHECK_BATCH)),
                            dtype=torch.float32, device=dev)
        n = 0
        for comp in (False, True):
            for idx, fac, start in buckets_of(low):
                idx_t = torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=dev)
                fac_t = torch.as_tensor(np.ascontiguousarray(fac), device=dev).float()
                e = check_bucket(w, idx_t, fac_t, start, comp,
                                 f"order-4 {mode} bucket at row {start}")
                if not comp:
                    main_err = max(main_err, e)
                n += 1
        print(f"kernel: every order-4 {mode} bucket ({n // 2}, Kahan off and on) at batch "
              f"{CHECK_BATCH} f32: ok, max|diff| {main_err:.3e}", flush=True)

    # -- 4. the slice
    n_tau = para.totalTauNum
    varK = gen.standard_normal((3, para.totalLoopNum, BATCH))
    varT = gen.random((n_tau, BATCH)) * BETA
    launches = {}
    for mode in ("fused", "bucketed"):
        c = compiled[mode]
        n_buckets = len(buckets_of(c.lowered))
        ref_leaf = make_leaf_evaluator(c.tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                                       dtype=torch.float64)
        ref_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float64, kernel=False)
        ref = ref_graph(ref_leaf(varK, varT))
        torch.cuda.synchronize()
        kernel_fn.launches = 0
        got = c(varK, varT)
        torch.cuda.synchronize()
        launches[mode] = kernel_fn.launches
        if launches[mode] != n_buckets:
            fail(f"{mode}: kernel launched {launches[mode]} times, expected {n_buckets}")
        if got.shape != (len(roots), BATCH) or not torch.isfinite(got).all():
            fail(f"{mode}: output not finite or of shape {tuple(got.shape)}")
        d = (got.double() - ref).abs()
        per_root = d.max(dim=1).values / ref.abs().max(dim=1).values
        scale_err = (d.max() / ref.abs().max()).item()
        worst = per_root.max().item()
        print(f"slice: {mode} f32 kernel vs f64 plain on the card, batch {BATCH}: "
              f"{launches[mode]} kernel launches per pass ({n_buckets} buckets), "
              f"max|d|/max|ref| {scale_err:.3e}, worst per-root {worst:.3e} "
              f"(limit {SLICE_TOL:g})", flush=True)
        if not worst <= SLICE_TOL:
            fail(f"{mode}: per-root scale-relative error {worst:.3e} > {SLICE_TOL}")

    # -- 5. throughput and per-pass times
    from torch.profiler import ProfilerActivity, profile

    def wall_ms(fn, n=10):
        """Mean time per call of fn between CUDA events over n calls, after
        a warm-up: the host's time where the host is the bottleneck."""
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def device_ms(fn, n=5):
        """Device time per call of fn: the kernels' own time, summed by the
        profiler over n calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
        if total <= 0:
            fail("the profiler saw no device time")
        return total / n / 1e3

    def in_turns(measure, k_fn, p_fn):
        """Kernel and plain in turns (plain, kernel, kernel, plain)."""
        p1, k1, k2, p2 = measure(p_fn), measure(k_fn), measure(k_fn), measure(p_fn)
        return (k1 + k2) / 2, (p1 + p2) / 2

    times = {}
    for mode in ("fused", "bucketed"):
        c = compiled[mode]
        bl = [(torch.as_tensor(np.ascontiguousarray(i, np.int32), device=dev),
               torch.as_tensor(np.ascontiguousarray(f), device=dev).float(), s)
              for i, f, s in buckets_of(c.lowered)]
        w = torch.as_tensor(gen.uniform(0.5, 1.5, (c.lowered.num_slots, BATCH)),
                            dtype=torch.float32, device=dev)

        def all_buckets(op):
            return lambda: [op(w, i, f, s) for i, f, s in bl]

        kd, pd = in_turns(device_ms, all_buckets(kernel_fn), all_buckets(plain_fn))
        kb, pb = in_turns(wall_ms, all_buckets(kernel_fn), all_buckets(plain_fn))
        times[mode] = (kd, pd)
        plain_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float32, kernel=False)
        leaves = c.leaf_fn(varK, varT)
        kg, pg = in_turns(wall_ms, lambda: c.graph_fn(leaves), lambda: plain_graph(leaves))
        print(f"time: {mode} batch {BATCH} f32, all {len(bl)} buckets of a pass: device "
              f"kernel {kd:.4f} ms vs plain {pd:.4f} ms; wall kernel {kb:.4f} ms vs plain "
              f"{pb:.4f} ms; graph phase wall kernel {kg:.4f} ms vs plain {pg:.4f} ms  "
              f"[{smi}]", flush=True)
        for batch in (BATCH, 2 * BATCH):
            mc_kw = dict(n_loop=para.totalLoopNum, num_tau=n_tau, batch=batch,
                         n_roots=len(roots), device=dev, dtype=torch.float32, beta=BETA)

            def one():
                mc_run(c.fn, iters=1, seed=SEED, **mc_kw)

            busy, wall = device_ms(one, n=10), wall_ms(one, n=20)
            sps = mc_samples_per_s(c.fn, iters=100, reps=3, **mc_kw)
            print(f"mc: {mode} batch {batch} f32: {sps:.1f} samples/s; per pass wall "
                  f"{wall:.4f} ms, device busy {busy:.4f} ms (idle share "
                  f"{max(0.0, 1 - busy / wall):.3f})  [{smi}]", flush=True)

    report = {"kernels": [{
        "name": "bucket_gather_reduce", "route": "cuda",
        "source": "feynmandiagram_tpu_torch/csrc/bucket_gather_reduce.cu",
        "replaces": "feynmandiagram_tpu/ops/kernels.py:82",
        "launches": launches["fused"], "max_abs_err": main_err,
        "ms": times["fused"][0], "plain_ms": times["fused"][1]}]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
