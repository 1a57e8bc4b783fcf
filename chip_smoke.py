#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the order-4 Gamma4 Monte-Carlo evaluation,
and its row-access probe path on the card and checks them.  Phases, one
output line or more each:

1. the card's name and power limit (nvidia-smi);
2. the build of both CUDA libraries from ``feynmandiagram_tpu_torch/csrc``,
   one nvcc each, and of the host helper ``graphcore.cpp`` (g++), all
   started together; the ``host:`` lines say whether the native helper or
   its numpy path ran;
3. the kernel against its plain PyTorch version on the card, on random
   buckets (n_op 1-4, float32 and float64, Kahan on and off) and on every
   bucket of the order-4 fused and bucketed lowerings at batch 256; then
   the level launch against ``level_gather_reduce_plain`` on every level
   of both lowerings at batch 256, 4096 and a ragged 4097, for the four
   storage x accumulation pairs, Kahan on (max|diff| must be 0) and off;
4. the slice: order-4 Gamma4 -> optimize -> ``compile_evaluator`` on cuda in
   float32 for sum_mode 'fused' and 'bucketed', against the port's plain
   path in float64 on the card, with the kernel's launch count per pass,
   which must be the number of levels that hold buckets;
5. per-pass device and wall times of the level launches, of the same kernel
   called bucket by bucket, and of the plain version (device time: CUDA
   events around launches queued behind a sleep kernel), per level beside
   the level's bound, the bound itself (bytes of the distinct rows a level
   reads and of the rows it writes, over 3.35 TB/s), a sweep of the
   launch geometry, ``torch.sparse.mm`` over the bucketed pass's buckets as
   the library yardstick, the fused pass's device time in bins of the
   launch's bytes, Monte-Carlo samples/s of both slices with their launch
   counts and the device's idle share (the profiler's busy time);
6. the bucket kernel's storage x accumulation pairs: kernel against plain
   for float32/float64 and bfloat16/float32 on random buckets and on every
   order-4 fused bucket, and against the float64 sum rounded once to
   storage; the order-4 fused slice through
   ``compile_evaluator(acc_dtype=float64)`` against the float64 plain path
   and against the float32/float64 plain path, its per-pass device times;
   the order-2 bfloat16/float32 graph phase against float64 at
   tests/test_lowering.py's bounds and against the bfloat16/float32 plain
   path.  Each bound that tells the accumulation type is shown to reject a
   control, the plain version accumulating in the storage type;
7. each of the nine row-access probe kernels against its plain version, on
   the JAX script's data and on random data;
8. the probe path: ``benchmarks.probe_mosaic_caps.main()`` with every probe
   count at 0 before it, its output against the JAX script's values, and
   the one PyTorch call that computes a probe's function, where there is
   one, timed beside it;
9. ``benchmarks.probe_gather.run()``: the streaming roofline and the
   gather strategies at the JAX script's shapes, the bucket kernel among
   them.

Then one JSON line on the ten kernels, and the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, and so
does a machine without CUDA: nothing runs on the CPU instead.  ``jax`` and
the JAX package ``feynmandiagram_tpu`` are blocked from import: the port
stands on its own.
"""
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
BATCH = 4096
CHECK_BATCH = 256
BETA, KF, LAM = 0.5, 1.919, 1.0
RTOL = {"float32": 1e-5, "float64": 1e-12}
SLICE_TOL = 1e-5   # max|f32 kernel - f64 plain| / max|f64 plain|, per root
# one ulp of a storage type relative to the value, at the bottom of a binade:
# a sum rounded once to storage may land one ulp apart in kernel and plain
STORE_ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
STORE_BITS = {"float32": 23, "bfloat16": 7}   # stored mantissa bits
# a wider accumulation against the plain path of the same storage and
# accumulation: one storage ulp of each root's scale (f32, bf16).  The same
# path accumulating in the storage type lies outside it (the controls)
PAIR_SLICE_TOL = 2.0 ** -23
PAIR_GRAPH_TOL = 2.0 ** -8
TF32_REL = 2.0 ** -11   # one-hot probe: one term of w rounded to TF32
TRACE_TRIES = 5         # profiler traces taken before one without device time fails
QUEUED_REPS = 5         # timed repeats of queued_ms, of which the median counts
QUEUED_BUCKETS = 16     # buckets timed in one queued_ms call
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet: the rate the bounds are taken at
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12}   # same sheet, dense
RAGGED_BATCH = 4097     # no multiple of 4: rows lose their 16-byte alignment
M = 2 ** 20
# (widest record in pieces, bytes a column group may touch): the kernel's
# launch geometry, None for what the wrapper picks
GEOMETRIES = (None, (4, 24 * M), (2, 24 * M), (1, 24 * M), (4, 6 * M), (4, 1024 * M))
# the JAX script's first two output values of each probe (on its data)
PROBE_FIRST = {"dma8": [704, 705], "dmagrp": [192, 193], "vmemrow": [704, 705],
               "vmem8": [704, 705], "acc": [2432, 2436], "onehot": [704, 705],
               "dynwrite": [0, 0], "dmadyn_dst": [632, 633], "take": [536, 537]}
PROBE_LINE = {"dma8": 39, "dmagrp": 61, "vmemrow": 82, "vmem8": 100, "acc": 122,
              "onehot": 143, "dynwrite": 162, "dmadyn_dst": 185, "take": 205}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    sys.modules["jax"] = None                   # the port must need neither jax
    sys.modules["feynmandiagram_tpu"] = None    # nor the JAX package
    import numpy as np
    from feynmandiagram_tpu_torch import native
    from feynmandiagram_tpu_torch.backends import compile_evaluator
    from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
    from feynmandiagram_tpu_torch.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram_tpu_torch.frontends.parquet import (DiagPara, Interaction, Ver4Diag,
                                                            vertex4)
    from feynmandiagram_tpu_torch.mc import mc_run, mc_samples_per_s
    from feynmandiagram_tpu_torch.backends.compile import leafmap_of
    from feynmandiagram_tpu_torch.benchmarks import card_name, median_ms, probe_gather
    from feynmandiagram_tpu_torch.benchmarks import probe_mosaic_caps as pm
    from feynmandiagram_tpu_torch.ops import build, kernels
    from feynmandiagram_tpu_torch.ops.evaluator import level_buckets, make_evaluator
    from feynmandiagram_tpu_torch.ops.lowering import lower
    from feynmandiagram_tpu_torch.ops.leaf_eval import make_leaf_evaluator

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_fn, plain_fn = kernels.bucket_gather_reduce, kernels.bucket_gather_reduce_plain
    level_fn, level_plain = kernels.level_gather_reduce, kernels.level_gather_reduce_plain

    # -- 1. card
    smi = card_name()
    print(f"card: {smi}", flush=True)
    clock = [time.perf_counter()]

    def phase(name):
        """Say how long the phase that ends here took."""
        clock.append(time.perf_counter())
        print(f"phase: {name} took {clock[-1] - clock[-2]:.1f} s", flush=True)

    dev_gen = torch.Generator(device=dev)
    dev_gen.manual_seed(SEED)

    def rand_w(rows, batch, dtype):
        """A weight buffer of uniform values in [0.5, 1.5), made on the card."""
        w = torch.rand((rows, batch), generator=dev_gen, dtype=torch.float32, device=dev)
        return (w + 0.5).to(dtype)

    # -- 2. build, one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        host_lib = pool.submit(native.native_available)
        list(pool.map(build.build, ("bucket_gather_reduce", "row_probes")))
        host_path = "native graphcore library (g++)" if host_lib.result() else "numpy path"
    print(f"build: bucket_gather_reduce, row_probes (nvcc) and graphcore (g++) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"host: CSE and levelling of the lowering run on the {host_path}", flush=True)
    phase("card and build")

    # -- 3. kernel against plain version
    def type_name(dtype):
        return str(dtype).split(".")[1]

    def check_bucket(w, idx, fac, start, compensated, label, acc_dtype=None):
        """Run kernel and plain version on copies of w; return max|diff|.
        Bound: |diff| <= rtol * sum_a |fac * prod_k w| (the terms' size), rtol
        of the accumulation type, plus one storage ulp of the terms' size
        where the sum is rounded to a narrower storage type."""
        count = idx.shape[2]
        wk, wp = w.clone(), w.clone()
        kernel_fn(wk, idx, fac, start, compensated=compensated, acc_dtype=acc_dtype)
        plain_fn(wp, idx, fac, start, compensated=compensated, acc_dtype=acc_dtype)
        wm = w.abs().double()
        plain_fn(wm, idx, fac.abs().double(), start)
        torch.cuda.synchronize()
        rows = slice(start, start + count)
        diff = (wk[rows].double() - wp[rows].double()).abs()
        bound = RTOL[type_name(acc_dtype or w.dtype)] * wm[rows]
        if acc_dtype not in (None, w.dtype):
            bound = bound + STORE_ULP[type_name(w.dtype)] * wm[rows]
        if not torch.isfinite(wk[rows]).all() or bool((diff > bound).any()):
            fail(f"kernel != plain on {label}: max|diff| {diff.max().item():.3e}")
        if not torch.equal(wk[:start], w[:start]) or not torch.equal(wk[start + count:],
                                                                     w[start + count:]):
            fail(f"kernel wrote outside its rows on {label}")
        return diff.max().item()

    gen = np.random.default_rng(SEED)

    def rand_case(S, B, A, C, n_op, dtype, fac_dtype=None):
        w = torch.as_tensor(gen.uniform(0.5, 1.5, (S + C, B)), dtype=dtype, device=dev)
        idx = torch.as_tensor(gen.integers(0, S, (n_op, A, C)), dtype=torch.int32, device=dev)
        fac = torch.as_tensor(gen.choice([1.0, -1.0, 0.5, -2.0], (A, C)),
                              dtype=fac_dtype or dtype, device=dev)
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
    para = DiagPara(type=Ver4Diag, innerLoopNum=4, hasTau=True, filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(roots, level=1)
    print(f"host: order-4 Gamma4 generated and optimized by the port's own front end in "
          f"{time.perf_counter() - t0:.1f} s ({len(roots)} roots)", flush=True)
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
        return [b for lvl in low.levels for b in level_buckets(lvl)]

    def tables_of(low, fac_dtype):
        """The packed tables of every level of low that holds buckets."""
        return [kernels.pack_level(level_buckets(lvl), dev, fac_dtype)
                for lvl in low.levels if level_buckets(lvl)]

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

    def check_levels(low, w, storage, acc, compensated, label):
        """Every level of low through the level launch and through its plain
        version, each level on the same input (the buffer as the plain
        version left it after the levels before).  Bound per element as in
        check_bucket; on the Kahan path kernel and plain sum in one order
        and must agree bit for bit.  Returns max|diff|."""
        fac_dtype = acc or storage
        wp = w.clone()
        wm = None if compensated else w.abs().double()   # the terms' size, for the bound
        worst = 0.0
        for lvl in low.levels:
            if not level_buckets(lvl):
                continue
            tables = kernels.pack_level(level_buckets(lvl), dev, fac_dtype)
            wk = wp.clone()
            level_fn(wk, tables, compensated=compensated, acc_dtype=acc)
            level_plain(wp, tables, compensated=compensated, acc_dtype=acc)
            diff = (wk.double() - wp.double()).abs()
            if compensated:
                ok = not bool(diff.any())
            else:
                level_plain(wm, kernels.pack_level(
                    [(i, np.abs(f), s) for i, f, s in level_buckets(lvl)], dev, torch.float64))
                bound = RTOL[type_name(fac_dtype)] * wm
                if acc not in (None, storage):
                    bound = bound + STORE_ULP[type_name(storage)] * wm
                ok = not bool((diff > bound).any())
            if not torch.isfinite(wk).all() or not ok:
                fail(f"level kernel != plain on {label}: max|diff| {diff.max().item():.3e}")
            written = torch.zeros(w.shape[0], dtype=torch.bool, device=dev)
            for start, count in tables.desc[:, :2].tolist():
                written[start:start + count] = True
            if not torch.equal(wk[~written], wp[~written]):
                fail(f"level kernel wrote outside its rows on {label}")
            worst = max(worst, diff.max().item())
        return worst

    phase("host pipeline and bucket checks")
    level_err = {}
    for mode in ("fused", "bucketed"):
        low = compiled[mode].lowered
        for storage, acc in ((torch.float32, None), (torch.float64, None),
                             (torch.float32, torch.float64), (torch.bfloat16, torch.float32)):
            tag = f"{type_name(storage)}/{type_name(acc or storage)}"
            errs = {}
            for batch in (CHECK_BATCH, BATCH, RAGGED_BATCH):
                w = rand_w(low.num_slots, batch, storage)
                for comp in (False, True):
                    errs[batch, comp] = check_levels(
                        low, w, storage, acc, comp,
                        f"order-4 {mode} {tag} batch {batch} compensated={comp}")
            kahan = max(e for (_, comp), e in errs.items() if comp)
            plain = max(e for (_, comp), e in errs.items() if not comp)
            if mode == "fused" and acc is None and storage == torch.float32:
                level_err = {"plain": plain, "kahan": kahan}
            print(f"kernel: level launch = plain on every level of the order-4 {mode} lowering, "
                  f"{tag}, batches {CHECK_BATCH}, {BATCH} and {RAGGED_BATCH}: Kahan max|diff| "
                  f"{kahan:.3e} (must be 0), plain sums max|diff| {plain:.3e}", flush=True)

    phase("level checks")

    # -- 4. the slice
    n_tau = para.totalTauNum
    varK = gen.standard_normal((3, para.totalLoopNum, BATCH))
    varT = gen.random((n_tau, BATCH)) * BETA
    launches = {}
    for mode in ("fused", "bucketed"):
        c = compiled[mode]
        n_buckets = len(buckets_of(c.lowered))
        n_levels = sum(1 for lvl in c.lowered.levels if level_buckets(lvl))
        ref_leaf = make_leaf_evaluator(c.tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                                       dtype=torch.float64)
        ref_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float64, kernel=False)
        ref = ref_graph(ref_leaf(varK, varT))
        torch.cuda.synchronize()
        kernel_fn.launches = level_fn.launches = 0
        got = c(varK, varT)
        torch.cuda.synchronize()
        launches[mode] = level_fn.launches + kernel_fn.launches
        if level_fn.launches != n_levels or kernel_fn.launches != 0:
            fail(f"{mode}: {level_fn.launches} level launches and {kernel_fn.launches} bucket "
                 f"launches, expected {n_levels} (one per level that holds buckets) and 0")
        if got.shape != (len(roots), BATCH) or not torch.isfinite(got).all():
            fail(f"{mode}: output not finite or of shape {tuple(got.shape)}")
        d = (got.double() - ref).abs()
        per_root = d.max(dim=1).values / ref.abs().max(dim=1).values
        scale_err = (d.max() / ref.abs().max()).item()
        worst = per_root.max().item()
        print(f"slice: {mode} f32 kernel vs f64 plain on the card, batch {BATCH}: "
              f"{launches[mode]} kernel launches per pass ({n_buckets} buckets in {n_levels} "
              f"levels), "
              f"max|d|/max|ref| {scale_err:.3e}, worst per-root {worst:.3e} "
              f"(limit {SLICE_TOL:g})", flush=True)
        if not worst <= SLICE_TOL:
            fail(f"{mode}: per-root scale-relative error {worst:.3e} > {SLICE_TOL}")

    phase("slices")

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

    def queued_ms(fn, n=1):
        """Device time per call of fn with the host out of the way: n calls
        are enqueued between two CUDA events behind a sleep kernel, which is
        lengthened until the first event is still pending when the host is
        done, so that the device never waits for the host.  The time counts
        the device's gaps between launches.  Median of QUEUED_REPS; fn must
        not wait for the device.  Kernel times are not taken from the
        profiler here: late in this script its traces on the card lost a
        pass's first kernel and, once, halved every kernel's duration."""
        return float(queued_each_ms([lambda: [fn() for _ in range(n)]])[0]) / n

    def queued_each_ms(fns):
        """queued_ms of each of fns, run once each in order in one queue
        behind one sleep kernel, with an event between them: their device
        times as they follow one another in a pass."""
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        cycles, runs = 10 ** 7, []
        while len(runs) < QUEUED_REPS:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
            torch.cuda._sleep(cycles)
            events[0].record()
            for fn, event in zip(fns, events[1:]):
                fn()
                event.record()
            starved = events[0].query()
            torch.cuda.synchronize()
            if not starved:
                runs.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
            elif cycles < 2 ** 32:
                cycles *= 2
            else:
                fail("the host did not enqueue a timed call within a sleep of 2^32 cycles")
        return np.median(np.asarray(runs), axis=0)

    def level_bounds(low, batch, elsize):
        """Per level that holds buckets, the least time the card could take
        and what sets it: bytes (every distinct row the level's buckets read
        and every row they write, once each, over the memory rate) against
        operations (a multiply per operand and an add per term and element,
        over the float32 rate).  Also the same bytes with the rows counted
        once per bucket, what a launch per bucket must move."""
        out = []
        for lvl in low.levels:
            bl = level_buckets(lvl)
            if not bl:
                continue
            rows_out = sum(i.shape[2] for i, _, _ in bl)
            per_level = len(np.unique(np.concatenate([i.ravel() for i, _, _ in bl])))
            per_bucket = sum(len(np.unique(i)) for i, _, _ in bl)
            flops = sum(i.shape[1] * i.shape[2] * (i.shape[0] + 1) for i, _, _ in bl) * batch
            t_bytes = (per_level + rows_out) * batch * elsize / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS["float32"]
            out.append({"ms": 1e3 * max(t_bytes, t_ops),
                        "by": "bytes" if t_bytes >= t_ops else "operations",
                        "per_bucket_ms": 1e3 * (per_bucket + rows_out) * batch * elsize
                        / HBM_BYTES_PER_S,
                        "rows": (per_level, rows_out,
                                 sum(i.shape[0] * i.shape[1] * i.shape[2] for i, _, _ in bl))})
        return out

    def sparse_buckets(low):
        """Each n_op = 1 bucket of low as the [count, num_slots] CSR matrix
        whose product with w is the bucket's function."""
        mats = []
        for idx, fac, _ in buckets_of(low):
            n_op, arity, count = idx.shape
            if n_op != 1:
                fail("sparse_buckets: a bucket of n_op > 1 is no single sparse product")
            rows = np.tile(np.arange(count), arity)
            coo = torch.sparse_coo_tensor(
                torch.as_tensor(np.stack([rows, idx[0].reshape(-1)]), device=dev),
                torch.as_tensor(np.asarray(fac, np.float32).reshape(-1), device=dev),
                (count, low.num_slots)).coalesce()
            mats.append(coo.to_sparse_csr())
        return mats

    def buckets_ms(op, w, bl, **kw):
        """Device time of op over the buckets bl: queued_ms of runs of
        QUEUED_BUCKETS buckets, summed.  A run's launches fit the queue that
        the host can fill while the device sleeps; a whole plain pass, up to
        ten launches a bucket, does not."""
        return sum(queued_ms(lambda: [op(w, i, f, s, **kw) for i, f, s in
                                      bl[k:k + QUEUED_BUCKETS]])
                   for k in range(0, len(bl), QUEUED_BUCKETS))

    def busy_ms(fn, n=10):
        """The profiler's device busy time per call of fn, for calls that
        wait for the device or copy from the host (the Monte-Carlo pass, the
        probes' plain versions): its kernels' own time summed over n calls,
        after one untraced call.  The host idles 10 ms at each end of the
        trace (without that the profiler on the card dropped the first
        kernels of short traces); a trace without device time is taken
        again, up to TRACE_TRIES times."""
        for _ in range(TRACE_TRIES):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(0.01)
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.01)
            total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA"))
            if total > 0:
                return total / n / 1e3
        fail(f"the profiler saw no device time in {TRACE_TRIES} traces")

    def launch_sizes(low, w, bl):
        """Device time of the fused pass's bucket launches by the launch's
        bytes: the launches of each bin, in pass order, timed by queued_ms
        (with the gaps between them).  Requested bytes: every gathered row,
        padding operands included, and every written row; real: gathered
        rows other than the constant-one row that pads operands and terms."""
        ones = [s for s, v in zip(np.asarray(low.const_slots), np.asarray(low.const_values))
                if v == 1.0]
        row = BATCH * 4
        bins = {"< 2 MiB": [[], 0, 0], "2-16 MiB": [[], 0, 0], ">= 16 MiB": [[], 0, 0]}
        for (idx, _, _), launch in zip(buckets_of(low), bl):
            n_op, arity, count = np.shape(idx)
            req = (n_op * arity + 1) * count * row
            real = (int(np.isin(idx, ones, invert=True).sum()) + count) * row
            key = "< 2 MiB" if req < 2 ** 21 else "2-16 MiB" if req < 2 ** 24 else ">= 16 MiB"
            bins[key] = [bins[key][0] + [launch], bins[key][1] + req, bins[key][2] + real]
        pass_us = 1e3 * buckets_ms(kernel_fn, w, bl)
        parts = []
        for key, (ops, req, real) in bins.items():
            if ops:
                t = 1e3 * queued_ms(lambda: [kernel_fn(w, i, f, s) for i, f, s in ops])
                parts.append(f"{key}: {len(ops)} launches, {t:.1f} us ({t / pass_us:.3f} of "
                             f"the pass, {t / len(ops):.2f} us each), real "
                             f"{real / t / 1e3:.1f} GB/s, requested {req / t / 1e3:.1f} GB/s")
        print(f"launches: fused batch {BATCH} f32, {len(bl)} bucket launches back to back, "
              f"{pass_us:.1f} us of device time; by requested bytes: " + "; ".join(parts)
              + f"  [{smi}]", flush=True)

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

        tabs = tables_of(c.lowered, torch.float32)

        def all_levels(geometry=None):
            return [lambda t=t: level_fn(w, t, geometry=geometry) for t in tabs]

        def level_pass(geometry=None):
            fns = all_levels(geometry)
            return lambda: [fn() for fn in fns]

        kd, pd = in_turns(lambda op: buckets_ms(op, w, bl), kernel_fn, plain_fn)
        ld1, per_level, ld2 = (queued_ms(level_pass()), queued_each_ms(all_levels()),
                               queued_ms(level_pass()))
        ld = (ld1 + ld2) / 2
        kb, pb = in_turns(wall_ms, all_buckets(kernel_fn), all_buckets(plain_fn))
        lb = wall_ms(level_pass())
        bounds = level_bounds(c.lowered, BATCH, 4)
        bound = sum(b["ms"] for b in bounds)
        times[mode] = {"level_ms": ld, "bucket_ms": kd, "plain_ms": pd, "bound_ms": bound,
                       "bound_by": max(bounds, key=lambda b: b["ms"])["by"]}
        if mode == "fused":
            launch_sizes(c.lowered, w, bl)
        plain_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float32, kernel=False)
        leaves = c.leaf_fn(varK, varT)
        kg, pg = in_turns(wall_ms, lambda: c.graph_fn(leaves), lambda: plain_graph(leaves))
        gq = queued_ms(lambda: c.graph_fn(leaves))
        print(f"time: {mode} batch {BATCH} f32, the buckets of a pass, device, back to back: "
              f"{len(tabs)} level launches {ld:.4f} ms ({bound / ld:.3f} of the bound "
              f"{bound:.4f} ms = distinct rows per level + written rows over 3.35 TB/s; rows "
              f"counted per bucket {sum(b['per_bucket_ms'] for b in bounds):.4f} ms); the same "
              f"kernel bucket by bucket, {len(bl)} launches, {kd:.4f} ms; plain {pd:.4f} ms.  "
              f"Wall: level launches {lb:.4f} ms, bucket by bucket {kb:.4f} ms, plain "
              f"{pb:.4f} ms; graph phase wall kernel {kg:.4f} ms vs plain {pg:.4f} ms, queued "
              f"{gq:.4f} ms  [{smi}]", flush=True)
        print(f"levels: {mode} batch {BATCH} f32, per level: device us / bound us (share), "
              f"rows read distinct + written (gathers requested): " + "; ".join(
                  f"L{k} {1e3 * t:.1f}/{1e3 * b['ms']:.1f} ({b['ms'] / t:.2f}) "
                  f"{b['rows'][0]}+{b['rows'][1]} ({b['rows'][2]})"
                  for k, (t, b) in enumerate(zip(per_level, bounds)))
              + f"; sum {1e3 * per_level.sum():.1f} us  [{smi}]", flush=True)
        for batch in (BATCH, 4 * BATCH):
            wg = w if batch == BATCH else rand_w(c.lowered.num_slots, batch, torch.float32)
            geo = {g: queued_ms(lambda: [level_fn(wg, t, geometry=g) for t in tabs])
                   for g in GEOMETRIES}
            print(f"geometry: {mode} batch {batch} f32, level launches of a pass, device ms by "
                  f"(widest record in pieces, MiB a column group may touch): " + ", ".join(
                      f"{'default' if g is None else (g[0], g[1] // M)} {t:.4f}"
                      for g, t in geo.items()) + f"  [{smi}]", flush=True)
            del wg
        if mode == "bucketed":
            mats = sparse_buckets(c.lowered)
            outs = [torch.sparse.mm(m, w) for m in mats]
            for (idx, fac, start), out in zip(bl, outs):
                wk = w.clone()
                kernel_fn(wk, idx, fac, start)
                d = (out - wk[start:start + out.shape[0]]).abs().max().item()
                if not d <= 1e-4 * out.abs().max().item():
                    fail(f"torch.sparse.mm differs from the kernel on the bucket at row {start}: "
                         f"max|diff| {d:.3e}")
            lib_ms = sum(queued_ms(lambda: [torch.sparse.mm(m, w) for m in
                                            mats[k:k + QUEUED_BUCKETS]])
                         for k in range(0, len(mats), QUEUED_BUCKETS))
            times[mode]["library_ms"] = lib_ms
            print(f"library: bucketed batch {BATCH} f32, torch.sparse.mm of each of the "
                  f"{len(mats)} buckets' CSR matrices with w, back to back: {lib_ms:.4f} ms "
                  f"(level launches {ld:.4f} ms)  [{smi}]", flush=True)
            del mats, outs
        for batch in (BATCH, 2 * BATCH):
            mc_kw = dict(n_loop=para.totalLoopNum, num_tau=n_tau, batch=batch,
                         n_roots=len(roots), device=dev, dtype=torch.float32, beta=BETA)

            def one():
                mc_run(c.fn, iters=1, seed=SEED, **mc_kw)

            level_fn.launches = kernel_fn.launches = 0
            mc_run(c.fn, iters=3, seed=SEED, **mc_kw)
            torch.cuda.synchronize()
            if level_fn.launches != 3 * len(tabs) or kernel_fn.launches != 0:
                fail(f"mc_run {mode}: {level_fn.launches} level and {kernel_fn.launches} bucket "
                     f"launches in 3 passes, expected {3 * len(tabs)} and 0")
            busy, wall = busy_ms(one), wall_ms(one, n=20)
            sps = mc_samples_per_s(c.fn, iters=100, reps=3, **mc_kw)
            print(f"mc: {mode} batch {batch} f32: {sps:.1f} samples/s, {len(tabs)} kernel "
                  f"launches per pass; per pass wall "
                  f"{wall:.4f} ms, device busy {busy:.4f} ms (idle share "
                  f"{max(0.0, 1 - busy / wall):.3f})  [{smi}]", flush=True)

    phase("times and Monte-Carlo runs")

    # -- 6. storage x accumulation pairs of the bucket kernel
    def rounding_excess(got, exact, size, storage, acc):
        """max |got - exact| / (half a storage ulp of the value + RTOL[acc] *
        the terms' size): at most 1 where got is the exact sum, accumulated
        to acc's accuracy and rounded once to the storage type."""
        mag = torch.maximum(got.abs(), exact.abs())
        ulp = torch.exp2((torch.frexp(mag).exponent - 1 - STORE_BITS[storage]).double())
        return ((got - exact).abs() / (0.5 * ulp + RTOL[acc] * size)).max().item()

    def check_pair(w, idx, fac, start, compensated, label, acc):
        """check_bucket, then the kernel against the float64 sum rounded once
        to storage; returns max|diff|, the kernel's rounding excess, and the
        excess of the control: the plain version accumulating in storage."""
        err = check_bucket(w, idx, fac, start, compensated, label, acc_dtype=acc)
        rows = slice(start, start + idx.shape[2])
        wk, wc, we, wm = w.clone(), w.clone(), w.double(), w.abs().double()
        kernel_fn(wk, idx, fac, start, compensated=compensated, acc_dtype=acc)
        plain_fn(wc, idx, fac, start, compensated=compensated)
        plain_fn(we, idx, fac.double(), start)
        plain_fn(wm, idx, fac.abs().double(), start)
        args = (we[rows], wm[rows], type_name(w.dtype), type_name(acc))
        excess = rounding_excess(wk[rows].double(), *args)
        if not excess <= 1.0:
            fail(f"kernel on {label} is not its sum rounded once: excess {excess:.3f}")
        return err, excess, rounding_excess(wc[rows].double(), *args)

    pairs = ((torch.float32, torch.float64), (torch.bfloat16, torch.float32))
    for storage, acc in pairs:
        tag = f"{type_name(storage)}/{type_name(acc)}"
        low = compiled["fused"].lowered
        w = torch.as_tensor(gen.uniform(0.5, 1.5, (low.num_slots, CHECK_BATCH)),
                            dtype=storage, device=dev)
        cases = [(rand_case(64, 300, 16, 40, n_op, storage, acc), comp,
                  f"random n_op={n_op} {tag} compensated={comp}")
                 for n_op in (1, 2, 3, 4) for comp in (False, True)]
        cases += [((w, torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=dev),
                    torch.as_tensor(np.ascontiguousarray(fac), device=dev).to(acc), start),
                   comp, f"order-4 fused bucket at row {start} {tag} compensated={comp}")
                  for comp in (False, True) for idx, fac, start in buckets_of(low)]
        res = [check_pair(*args, comp, label, acc) for args, comp, label in cases]
        err, excess, control = (max(r[i] for r in res) for i in range(3))
        print(f"kernel: {tag} on random n_op 1-4 and every order-4 fused bucket at batch "
              f"{CHECK_BATCH}, Kahan off and on ({len(cases)} cases): max|diff| vs plain "
              f"{err:.3e}; rounded-once excess kernel {excess:.6f} (limit 1), control "
              f"(plain accumulating in {type_name(storage)}) {control:.1f}", flush=True)
        if not control > 1.0:
            fail(f"{tag}: the control passed the rounded-once bound, which therefore "
                 f"cannot tell the accumulation types apart")

    def per_root(a, b):
        """Worst per-root max|a - b| / max|b|."""
        d = (a.double() - b.double()).abs().max(dim=1).values
        return (d / b.double().abs().max(dim=1).values).max().item()

    t0 = time.perf_counter()
    c64 = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                            lam=LAM, device=dev, dtype=torch.float32,
                            acc_dtype=torch.float64, sum_mode="fused")
    ref = make_evaluator(c64.lowered, device=dev, dtype=torch.float64, kernel=False)(
        make_leaf_evaluator(c64.tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                            dtype=torch.float64)(varK, varT))
    level_fn.launches = 0
    got = c64(varK, varT)
    torch.cuda.synchronize()
    n_levels = sum(1 for lvl in c64.lowered.levels if level_buckets(lvl))
    if level_fn.launches != n_levels:
        fail(f"f64-acc slice: kernel launched {level_fn.launches} times, expected {n_levels}")
    if got.dtype != torch.float64 or got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"f64-acc slice: output {got.dtype} {tuple(got.shape)} or not finite")
    worst = per_root(got, ref)
    print(f"slice: fused f32 storage / f64 accumulation via compile_evaluator (built in "
          f"{time.perf_counter() - t0:.1f} s) vs f64 plain, batch {BATCH}: "
          f"{level_fn.launches} kernel launches per pass, worst per-root {worst:.3e} "
          f"(limit {SLICE_TOL:g})", flush=True)
    if not worst <= SLICE_TOL:
        fail(f"f64-acc slice: per-root scale-relative error {worst:.3e} > {SLICE_TOL}")
    leaves = c64.leaf_fn(varK, varT)
    same = make_evaluator(c64.lowered, device=dev, dtype=torch.float32,
                          acc_dtype=torch.float64, kernel=False)(leaves)
    acc_err = per_root(c64.graph_fn(leaves), same)
    control = per_root(make_evaluator(c64.lowered, device=dev, dtype=torch.float32,
                                      kernel=False)(leaves), same)
    print(f"slice: the same graph phase vs the f32/f64 plain path on the same leaves: worst "
          f"per-root {acc_err:.3e} (limit {PAIR_SLICE_TOL:.3e}); control (plain f32/f32) "
          f"{control:.3e}", flush=True)
    if not acc_err <= PAIR_SLICE_TOL < control:
        fail("f64-acc slice: kernel outside, or control inside, the f32/f64 plain bound")
    bl = [(torch.as_tensor(np.ascontiguousarray(i, np.int32), device=dev),
           torch.as_tensor(np.ascontiguousarray(f), device=dev).double(), s)
          for i, f, s in buckets_of(c64.lowered)]
    w = torch.as_tensor(gen.uniform(0.5, 1.5, (c64.lowered.num_slots, BATCH)),
                        dtype=torch.float32, device=dev)

    kd64, pd64 = in_turns(lambda op: buckets_ms(op, w, bl, acc_dtype=torch.float64),
                          kernel_fn, plain_fn)
    tabs64 = tables_of(c64.lowered, torch.float64)
    ld64 = queued_ms(lambda: [level_fn(w, t, acc_dtype=torch.float64) for t in tabs64])
    print(f"time: fused batch {BATCH} f32 storage / f64 accumulation, the buckets of a pass, "
          f"device, back to back: {len(tabs64)} level launches {ld64:.4f} ms (f32/f32 "
          f"{times['fused']['level_ms']:.4f} ms above); bucket by bucket, {len(bl)} launches, "
          f"{kd64:.4f} ms vs plain {pd64:.4f} ms  [{smi}]", flush=True)

    para2 = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True, filter=(NoHartree,),
                     interaction=(Interaction(ChargeCharge, Instant),))
    roots2 = [row["diagram"] for row in vertex4(para2)]
    optimize_inplace(roots2, level=1)
    leafmap2 = leafmap_of(roots2)
    low2 = lower(roots2, leafmap2, sum_mode="bucketed")
    vals = np.random.default_rng(2).uniform(0.25, 4.0, (len(leafmap2), 16))
    f64 = make_evaluator(low2, device=dev, dtype=torch.float64, kernel=False)(vals)
    level_fn.launches = 0
    mixed = make_evaluator(low2, device=dev, dtype=torch.bfloat16,
                           acc_dtype=torch.float32)(vals.astype(np.float32))
    torch.cuda.synchronize()
    denom = torch.maximum(f64.abs(), 1e-3 * f64.abs().max())
    rel = (mixed.double() - f64).abs() / denom
    med, top = rel.median().item(), rel.max().item()
    print(f"graph: order-2 bucketed bf16 storage / f32 accumulation vs f64, batch 16: "
          f"{level_fn.launches} kernel launches, median rel {med:.3e} (limit 1e-2), max "
          f"{top:.3e} (limit 0.5)", flush=True)
    if mixed.dtype != torch.float32 or level_fn.launches == 0 or not (med < 1e-2 and
                                                                      top < 0.5):
        fail("bf16/f32 graph phase outside tests/test_lowering.py's bounds")
    vals32 = vals.astype(np.float32)
    same = make_evaluator(low2, device=dev, dtype=torch.bfloat16, acc_dtype=torch.float32,
                          kernel=False)(vals32)
    acc_err = per_root(mixed, same)
    control = per_root(make_evaluator(low2, device=dev, dtype=torch.bfloat16,
                                      kernel=False)(vals32), same)
    print(f"graph: the same vs the bf16/f32 plain path: worst per-root {acc_err:.3e} (limit "
          f"{PAIR_GRAPH_TOL:.3e}); control (plain bf16/bf16) {control:.3e}", flush=True)
    if not acc_err <= PAIR_GRAPH_TOL < control:
        fail("bf16/f32 graph phase: kernel outside, or control inside, the bf16/f32 plain "
             "bound")

    phase("dtype pairs")

    # -- 7. the row-access probe kernels against their plain versions
    def probe_rand_rows(S):
        return {"dma8": [(S - 8,), (0,), (S // 3,)], "dmagrp": [(S - 1,), (13,)],
                "vmemrow": [(300,), (-5,), (-300,), (17,)],
                "vmem8": [(252,), (-3,), (100,)],
                "acc": [(-7, 255, 1000, -1000), (17, 256, 1031, 9)],
                "onehot": [(251,), (-3,), (100,), (2 ** 31 - 1,)],
                "dynwrite": [(-3,), (17,)],
                "dmadyn_dst": [(S // 8 - 1, -4), (3, 1), (3, 2), (3, 3)],
                "take": [(0,)]}

    def rows_t(r):
        return torch.tensor((tuple(r) + (0, 0, 0))[:4], dtype=torch.int32)

    probe_err = {}
    w_p, rows_p = pm.probe_inputs(dev)
    for label, case, plain in pm.CASES:
        name = case.__name__[len("case_"):]
        got, ref = case(w_p, rows_p), plain(w_p, rows_p)
        torch.cuda.synchronize()
        if not torch.equal(got, ref) or got.reshape(-1)[:2].tolist() != PROBE_FIRST[name]:
            fail(f"probe {name} on the JAX script's data: {got.reshape(-1)[:2].tolist()} "
                 f"vs plain {ref.reshape(-1)[:2].tolist()}, JAX {PROBE_FIRST[name]}")
        err, n = 0.0, 0
        for S, B in ((4096, 512), (1000, 100)):
            wr = torch.as_tensor(gen.standard_normal((S, B)), dtype=torch.float32, device=dev)
            for r in probe_rand_rows(S)[name]:
                got, ref = case(wr, rows_t(r)), plain(wr, rows_t(r))
                torch.cuda.synchronize()
                d = (got - ref).abs()
                bound = TF32_REL * ref.abs() if name == "onehot" else torch.zeros_like(ref)
                if got.shape != ref.shape or bool((d > bound).any()):
                    fail(f"probe {name} on random data {S}x{B}, rows {r}: max|diff| "
                         f"{d.max().item():.3e}")
                err, n = max(err, d.max().item()), n + 1
        probe_err[name] = err
        print(f"probe: {name} kernel = plain on the JAX data and {n} random cases "
              f"({'within 2^-11 relative, TF32' if name == 'onehot' else 'exact'}), "
              f"max|diff| {err:.3e}", flush=True)
    for name, r in (("dma8", (4089,)), ("dmagrp", (4096,)), ("dmadyn_dst", (512,))):
        try:
            getattr(pm, f"case_{name}")(w_p, rows_t(r))
        except ValueError:
            continue
        fail(f"probe {name}: an out-of-range source {r} did not raise")
    print("probe: out-of-range copy sources raise (dma8, dmagrp, dmadyn_dst)", flush=True)

    # -- 8. the probe path, counts from 0
    for _, case, _ in pm.CASES:
        case.launches = 0
    results = pm.main()
    probe_launches = {case.__name__[len("case_"):]: case.launches for _, case, _ in pm.CASES}
    for res in results:
        name = res["case"].__name__[len("case_"):]
        if not res["ok"] or res["first"] != PROBE_FIRST[name] or probe_launches[name] < 1:
            fail(f"probe path: {name} ok={res['ok']} first={res.get('first')} "
                 f"launches={probe_launches[name]}")
    print(f"probe path: all nine cases OK, launches {probe_launches}", flush=True)
    # device time alone, beside main()'s per-call event times that include
    # the host's launch work
    probe_dev = {}
    for _, case, plain in pm.CASES:
        probe_dev[case.__name__[len("case_"):]] = (
            busy_ms(lambda: case(w_p, rows_p), n=20), busy_ms(lambda: plain(w_p, rows_p), n=20))
    print("probe device time per call, kernel vs plain: " + ", ".join(
        f"{name} {k * 1e3:.2f} vs {p * 1e3:.2f} us" for name, (k, p) in probe_dev.items())
        + f"  [{smi}]", flush=True)

    # the one PyTorch call that computes a probe's function, where there is
    # one, timed as main() times the kernel (pm.median_ms: per call, the
    # host's launch work included).  acc (a gather and a sum), dynwrite and
    # dmadyn_dst (a fill and a copy) take two calls each: none
    r_p = [int(r) for r in rows_p.tolist()]
    blk = w_p[:pm.BLOCK_ROWS]
    sel = (torch.arange(pm.BLOCK_ROWS, device=dev)[None, :]
           == r_p[0] + torch.arange(8, device=dev)[:, None]).float()
    take_idx = torch.tensor(pm.TAKE_ROWS, device=dev)
    g8 = 8 * (r_p[0] // 8)
    library_calls = {
        "dma8": lambda: w_p[r_p[0]:r_p[0] + 8].clone(),
        "dmagrp": lambda: w_p[g8:g8 + 8].clone(),
        "vmemrow": lambda: blk[r_p[0]:r_p[0] + 1].clone(),
        "vmem8": lambda: blk[r_p[0]:r_p[0] + 8].clone(),
        "onehot": lambda: torch.matmul(sel, blk),
        "take": lambda: torch.index_select(blk, 0, take_idx)}
    probe_lib = {}
    for _, case, _ in pm.CASES:
        name = case.__name__[len("case_"):]
        call = library_calls.get(name)
        if call is not None and not torch.equal(call(), case(w_p, rows_p)):
            fail(f"probe {name}: its library call gives another result than the kernel")
        probe_lib[name] = median_ms(call) if call is not None else None
    # bound: the rows a probe must read and write, once each, over the memory
    # rate; for onehot also its 2 * 8 * 256 * B operations over the TF32 rate
    row_bytes = w_p.shape[1] * 4
    probe_rows = {"dma8": 16, "dmagrp": 16, "vmemrow": 2, "vmem8": 16, "acc": 5, "onehot": 16,
                  "dynwrite": 9, "dmadyn_dst": 16, "take": 16}
    probe_bound = {}
    for name, n_rows in probe_rows.items():
        t_bytes = n_rows * row_bytes / HBM_BYTES_PER_S
        t_ops = (2 * 8 * pm.BLOCK_ROWS * w_p.shape[1] / PEAK_FLOPS["tf32"]
                 if name == "onehot" else n_rows * w_p.shape[1] / PEAK_FLOPS["float32"])
        probe_bound[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                             else "operations")
    print("probe library call per call, and bound: " + ", ".join(
        f"{name} {'none' if probe_lib[name] is None else format(1e3 * probe_lib[name], '.2f') + ' us'}"
        f" / {1e6 * probe_bound[name][0]:.1f} ns ({probe_bound[name][1]})"
        for name in PROBE_LINE) + "; a launch's floor, not the bound, is what the probes meet"
        + f"  [{smi}]", flush=True)

    phase("probes")

    # -- 9. gather strategies and the streaming roofline
    kernel_fn.launches = 0
    gather = probe_gather.run()
    if not gather["bucket_ok"] or kernel_fn.launches < 1:
        fail(f"probe_gather: bucket kernel check {gather['bucket_ok']}, "
             f"{kernel_fn.launches} launches")

    phase("gather probe")

    by_name = {res["case"].__name__[len("case_"):]: res for res in results}
    fused, bucketed = times["fused"], times["bucketed"]
    report = {"kernels": [{
        "name": "bucket_gather_reduce", "route": "cuda",
        "source": "feynmandiagram_tpu_torch/csrc/bucket_gather_reduce.cu",
        "replaces": "feynmandiagram_tpu/ops/kernels.py:82",
        "launches": launches["fused"], "launches_per_pass": launches["fused"],
        "max_abs_err": max(main_err, level_err["plain"]),
        "max_abs_err_kahan": level_err["kahan"],
        "ms": fused["level_ms"], "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"], "library_ms": None,
        "bucket_by_bucket_ms": fused["bucket_ms"],
        "bucketed": {"launches_per_pass": launches["bucketed"], "ms": bucketed["level_ms"],
                     "plain_ms": bucketed["plain_ms"], "bound_ms": bucketed["bound_ms"],
                     "bound_by": bucketed["bound_by"], "library_ms": bucketed["library_ms"],
                     "bucket_by_bucket_ms": bucketed["bucket_ms"]}}] + [{
            "name": f"probe_{name}", "route": "cuda",
            "source": "feynmandiagram_tpu_torch/csrc/row_probes.cu",
            "replaces": f"benchmarks/probe_mosaic_caps.py:{PROBE_LINE[name]}",
            "launches": probe_launches[name], "max_abs_err": probe_err[name],
            "ms": by_name[name]["ms"], "plain_ms": by_name[name]["plain_ms"],
            "bound_ms": probe_bound[name][0], "bound_by": probe_bound[name][1],
            "library_ms": probe_lib[name]}
            for name in PROBE_LINE]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
