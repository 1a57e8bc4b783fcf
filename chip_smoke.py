#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the order-4 Gamma4 Monte-Carlo evaluation,
and its row-access probe path on the card and checks them.  Phases, one
output line or more each:

1. the card's name and power limit (nvidia-smi);
2. the build of the three CUDA libraries from ``feynmandiagram_tpu_torch/csrc``
   (the level kernel, the leaf kernel, the probes), one nvcc each, and of the host helper ``graphcore.cpp`` (g++), all
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
   which must be the number of levels that hold buckets or plans (a
   ``ProdPlan`` or ``PowerPlan`` rides the level launch), and the leaf
   kernel's (once);
4'. the leaf phase's kernel (``csrc/leaf_eval.cu``: ``leaf_eval``) against
   its plain version (``leaf_prep_plain`` then ``leaf_values_plain``) on the
   card (``leaf kernel:`` lines), on the leaf tables of order-4 Gamma4 here
   (also with items of 3 leaf rows, which split basis rows, and a table of
   V-only basis rows and rows of no group), of config 4, GV sigma 6 and
   Gamma4 orders 5 and 6 in their phases: batch 4096 on float32 samples and
   4097 on float64 ones, computing in float64 and float32, leaves stored in
   float32, float64 and bfloat16, each element within LEAF_ULPS ulps of its
   type (bit for bit expected); the issue rate of the
   phase's float64 and float32 operations on a micro-kernel (``leaf
   floor:`` lines); the kernel, its plain version and the phase back to
   back beside the byte bound and the operation floor that those rates give
   (``leaf time:`` lines); by the profiler's names, one leaf phase is the
   kernel once and nothing else;
4a. the scale-out layer (``parallel``, ``utils.initialize_distributed``),
   ``scale-out:`` lines: NCCL with one rank over a ``file://`` store, where
   ``shard_compiled`` of the fused slice and ``make_mc_step`` must equal the
   unsharded evaluator and ``mc.mc_run`` bit for bit; the order-4 Gamma4
   graph-sharded pass (``lower_sharded_best`` at 4 ranks, fused, float32) on
   a local 4-rank graph mesh on the card, its planner's sizes against the
   JAX package's, its 13 level launches a rank reading the level's halo
   (``level_gather_reduce(src=halo)``), bit for bit against the unsharded
   evaluator on the same lowering at batch 4096 and 4097 and within
   SLICE_TOL of the float64 plain path; the same for the bucketed lowering
   (16 launches a rank); the kernel against its plain version through
   ``src`` on every level of rank 0 for the four dtype pairs; the
   graph-sharded MC step of ``examples/config5_serving.py`` on a local 4 x 2
   mesh against the unsharded evaluator on the same draws;
   ``benchmarks/certify_sharded.py``'s line; the sharded pass's device and
   wall time, its level launches back to back, its halo gathers and the
   unsharded pass on the same lowering;
4b. the Hubbard atom (``models.hubbard_atom``) at beta 2.3, U 1, mu 0, the
   lowest Matsubara frequency, orders 1-5, float32: the kernel's launches
   in one pass of each order against the number of levels that hold
   buckets or plans (2 / 5 / 9 / 13 / 17), the pass through the kernel against the
   plain path in float64 on the same seeded varT, ``sigma_mc`` against
   the closed-form series (order 1 exactly -U/2, orders 2-5 within 5
   stderr), and each order's device and wall time of one pass;
4c. config 4, the order-4 self-energy's counterterm series
   (``benchmarks.bench_config4.config4_roots``: Σ -> ``taylorAD([2, 2])``
   -> 36 roots whose leaves carry G and V derivative orders 0-2, generated
   once and lowered fused and bucketed), float32 on cuda: the level
   launches of a pass against the levels that hold buckets or plans, no launch
   bucket by bucket, the pass against the port's float64 plain path (worst
   root and its order tuple), fused at batch 4096, 4097 and 8192, bucketed
   at 256; for the fused lowering, Monte-Carlo samples/s at batch 8192 and
   16384 with the device's busy time, idle share and the level launches'
   share, the leaf and graph phases' wall and device time alone, and the
   level launches' device time per level beside each level's bound at
   8192;
4d. the exact-diagonalization oracle (``models.atom_ed``) on cuda in
   float64: the U=0 atom's g(τ) against the free kernel and against the
   same on the CPU, the ED self-energy against ``exact_sigma``, the dimer's
   first-order hopping identity and Wick's theorem at U=0;
5. per-pass device and wall times of the level launches, of the same kernel
   called bucket by bucket, and of the plain version (device time: CUDA
   events around launches queued behind a sleep kernel), per level beside
   the level's bound, the bound itself (bytes of the distinct rows a level
   reads and of the rows it writes, over 3.35 TB/s), a sweep of the
   launch geometry, ``torch.sparse.mm`` over the bucketed pass's buckets as
   the library yardstick, the fused pass's device time in bins of the
   launch's bytes, Monte-Carlo samples/s of both slices with their launch
   counts and the device's idle share (1 - the profiler's busy time, the
   union of the kernels' intervals, / the wall of the same traced calls,
   CUDA events around them, from one trace; a busy time above that wall
   fails as a faulty reading);
5a. GV-table diagrams from the port's bundled tables (``gv:`` lines): Σ at
   order 6 (``diagsGV`` -> ``optimize_inplace(1)`` -> ``compile_evaluator``)
   fused and bucketed at batch 4096 in float32, its slots, edges, levels
   and buckets against the CPU lowering's (GV_SIGMA6), the pass against the
   float64 plain path, every level against its plain version, the level
   launches beside their bound and the plain version, ``torch.sparse.mm``
   of the bucketed pass's buckets, samples/s of the fused pass at 4096 and
   16384; charge polarization at order 5 through the same checks; the Σ-3
   counterterm file of the Feynman-graph reader beside ``taylorAD``'s
   coefficient of the same order, leaf == 1 on the card against the host
   interpreter; the torch source export of the optimized Σ-4 roots against
   the level launches in float64; ``benchmarks/profile_pass.py`` of the
   fused order-4 Gamma4 pass in a fresh process (``gv profile_pass:``
   lines), its phases' device time against the pass's ``queued_ms``, and
   the unprofiled pass's wall with the scopes' code and without;
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
   the JAX script's data and on random data; acc at every edge of its clamp
   in each of its four rows and in all four at once, and both designs of
   onehot (the select as a read, exact; on tensor cores in TF32, within
   2^-11 relative) at every residue mod 8 about 0, 8 and K - 8, on blocks of
   8 to 300 rows and widths from one 16-byte piece to 16384 columns, acc bit
   for bit; dynwrite bit for bit at every residue of r mod 8,
   negative r and r past the block among them, on blocks of 1 to 300 rows
   holding -0.0, infinities and NaNs, at the same widths; the two slice kernels
   (vmemrow, vmem8) and their TMA variants also at every edge of the
   start's clamp, on blocks shorter than 256 rows and at widths from one
   16-byte piece to 16384 columns; the two copies (dma8, dmagrp) and their
   TMA variants at the first, the last and an unaligned middle start, at
   every residue mod 8 of a middle and of the last group, at the same
   widths, on 8, 1000 and 4096 rows and on a 5.2 GB buffer whose byte
   offsets pass 2^32;
8. the probe path: ``benchmarks.probe_mosaic_caps.main()`` with every probe
   count at 0 before it, its output against the JAX script's values; then
   every probe's kernel, plain version and the one PyTorch call that
   computes its function (``probe_library_calls``), each on two clocks:
   device time (the profiler's busy time) and per-call time (CUDA events
   around one call on an idle stream, the host's launch work included); the
   four copy kernels beside their TMA variants, acc, onehot's two designs
   and dynwrite (beside dma8) in turns, alone and 20 back to back on the
   device clock; the two copies at
   64, 128 and 256 threads a block; a launch's floor, the time of an empty
   kernel on three clocks, and every probe's device time over it;
9. ``benchmarks.probe_gather.run()``: the streaming roofline and the
   gather strategies at the JAX script's shapes, the bucket kernel among
   them;
10. Gamma4 at orders 3, 5 and 6 (``gamma4`` lines), fused and bucketed,
   float32: order 3 generated and lowered here, orders 5 and 6 through
   ``benchmarks/gamma4_orders.py`` in child processes started after the
   build, which generate, optimize and ``export_artifact`` them on the host
   beside phases 3-9 (``gamma4 host:`` lines, the leaf tables' seconds
   among them), then ``load_artifact`` -> ``make_leaf_evaluator`` +
   ``make_evaluator`` here.  For each lowering: its counts against the CPU
   lowering's (GAMMA4), the pass against the float64 plain path (batch
   4096, 512 at order 6) and, as a control, the same pass on leaves computed
   in float32 arithmetic, as the JAX package computes them (the leaf phase
   computes in float64 and rounds once), every level against its plain
   version, the level launches beside their bound and, bucketed, beside ``torch.sparse.mm``,
   the Monte-Carlo lines, and from order 5 on where a pass's device time
   goes (leaf phase, the eager buffer's zeroed rows, level launches, plain
   ProdPlans and PowerPlans).  The
   scripts ``scaling`` (order 3, local meshes of 1, 2 and 4 ranks),
   ``scan_merge`` and ``probe_split`` (order 4) and ``probe_structure`` (the
   order-5 fused lowering); config 5 at its own order 5
   (``examples/config5_serving.serve`` on the 4 x 2 mesh, bit for bit with
   the unsharded evaluator) and ``certify_sharded`` at order 5 on 8 graph
   ranks; then four passes whose weight buffer holds more than 2^31
   elements (BIG_PASSES), each held bit for bit against three windows of
   WINDOW columns of the same leaf values run alone.  A root outside
   SLICE_TOL prints ``MISS:`` with its error under Kahan sums, float64
   accumulation and a float64 graph phase, and fails the run at the
   phase's end, after a JSON line of the misses;
10a. the eager pass from its launch plans (``launch plan:`` and ``launch
   plan time:`` lines, ``launch_plan_checks``): order-4 Gamma4 fused at
   4096 and config 4 fused at 8192, the graph phase from the plan (each run
   of levels one ``levels_gather_reduce``) bit for bit against the
   level-by-level path in float32, float32/float64 and compensated, 13 / 37
   level launches a pass, all of them from the run launcher, one plan
   built; the eager call against the call before the plans bit for bit,
   and both calls' dispatch, call and host-only clocks in turns;
10b. stretches of thin levels as column runs (``column run:`` and ``column
   run time:`` lines, ``column_run_checks``; alone: ``python3 chip_smoke.py
   --column-runs``): order-4 Gamma4 fused at 4096, 4097 and 16384, config 4
   fused at 8192 and 16384 and the GV self-energy renormalized to order 6
   at 4096, 8192 and 16384, the stretches the launch plan cuts; in the four
   storage x accumulation pairs, plain and compensated, the eager pass from
   the plan against the level-by-level path bit for bit over the whole
   buffer, with the launches counted, and each stretch's column run alone
   against its plain version bit for bit; the captured pass likewise in
   float32; each stretch's column run timed against its levels' own
   launches and its bound.  A level's launch count elsewhere in this script
   is the levels launched, alone or in column runs;
11. the whole pass captured as CUDA graphs, the counterpart of the JAX
   package's ``jit`` (``jit:``, ``jit mc:`` and ``jit time:`` lines):
   order-4 Gamma4 fused and bucketed through ``compile_evaluator(jit=True)``
   at batch 4096, a ragged 4097 and 8192; config 4 fused at 8192, GV
   sigma 6 fused and Gamma4 order 6 fused and bucketed at 4096 through
   ``CompiledEvaluator.jitted()``: the captured pass (its first call and a
   replay) bit for bit against the eager pass where two eager passes agree
   bit for bit, else within SLICE_TOL of the float64 plain path;
   ``mc_run(jit=True)`` against ``mc_run(jit=False)`` on one seed; then, the
   eager pass beside the captured one, samples/s in turns, wall, profiler
   busy time, idle share, device time with the host out of the way, the
   host's time a pass and a replay, the level kernels a pass counted by the
   profiler's kernel names and by the launch counters (a replay counts its
   graph's launch manifest: the eager pass's launches, a pass) and the peak
   of allocated memory, at batches
   4096, 8192 and 16384 (order 6 at 4096 and 8192: 16384 passes 2^31
   elements of w; bucketed at 4096); the Hubbard atom at orders 1-5 and
   65,536 through ``build_sigma_evaluator(jit=True)``, two U through one
   captured evaluator against two eager calls, ``sigma_mc(jit=True)``
   against the closed-form series, and the same clocks.  Each graph is
   freed before the next case; a failed capture or replay fails the run;
12. the sharded passes captured (``jit sharded:``, ``jit shard time:``
   lines): the order-4 Gamma4 graph-sharded pass, fused and bucketed,
   through ``make_graph_sharded_evaluator(jit=True)`` on the local 4-rank
   graph mesh at batch 4096 and 4097 and on a local 2 x 2 graph x batch
   mesh at 4096 and 4098; ``shard_compiled(jit=True)`` and
   ``make_mc_step(jit=True)`` on a local 4-rank sample mesh and on the
   one-rank NCCL mesh, and the graph-sharded pass with its graph axis over
   that NCCL group; config 5 at order 5, ``config5_serving.serve(jit=True)``
   on the 4 x 2 mesh: each captured call (its first call, and a replay
   after an eager call) bit for bit against the eager one, and eager and
   captured clocks side by side (samples/s, wall, busy, idle, host ms, level
   kernels a call by the profiler's names, the halo gathers' device time,
   peak memory); ``benchmarks/scaling.py`` at order 3 on 1, 2 and 4 local
   ranks, eager and captured in one table (``jit scaling:`` lines); then
   ``benchmarks.probe_bucket_fusion.run()`` at the JAX
   script's shapes (``probe_bucket_fusion:`` lines): the level kernel bit
   for bit against its plain version in (f32, f32) and (bf16, f32), every
   PyTorch formulation of the padded sum bucket against it, and each one's
   device time beside its bound.

Then the run's seconds, one JSON line on the eleven kernels, and the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, and so
does a machine without CUDA: nothing runs on the CPU instead.  ``jax`` and
the JAX package ``feynmandiagram_tpu`` are blocked from import: the port
stands on its own.
"""
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STARTED = time.perf_counter()
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
TF32_REL = 2.0 ** -11   # one-hot select on tensor cores: one term of w rounded to TF32
# relative bound of each onehot design against the float32 product: the
# select as a read (case_onehot, of record) is exact, the TF32 product not
ONEHOT_REL = {"onehot": 0.0, "onehot_mma": TF32_REL}
TRACE_TRIES = 5         # profiler traces taken before one without device time fails
# kernels of torch.cuda._sleep launched at the start of every profiler trace
# and left out of its counts: on the card a trace loses its first few kernel
# records (the first 8 of a Monte-Carlo pass's, which include level kernels)
PROFILE_LEAD = 64
QUEUED_REPS = 5         # timed repeats of queued_ms, of which the median counts
QUEUED_BUCKETS = 16     # buckets timed in one queued_ms call
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet: the rate the bounds are taken at
# the scale-out phase: the graph axis, the order-4 sharded plans' sizes as the
# JAX package's planner gives them (full slots, slots a rank, halo bytes a
# sample in float32, halo padding, early share) and level launches a rank;
# the MC step's iterations and its tolerance where the sums are not
# reproduced bit for bit
N_GRAPH = 4
SHARD_PLAN = {"fused": ((11680, 1846, 64720, 1.092, 0.432), 13),
              "bucketed": ((22590, 3083, 108576, 1.059, 0.190), 16)}
SHARD_MC_ITERS, SHARD_MC_TOL = 4, 1e-6
# same sheet, dense; float64 outside the tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "float64": 34e12}
# the leaf kernel against its plain version on the card: the most a value
# may differ, in ulps of the leaves' storage type.  The plain version
# repeats the kernel's operations in their order, so 0 is expected; 1 allows
# a last-bit difference of CUDA's and PyTorch's exp or log1p
LEAF_ULPS = 1
LEAF_KERNELS = ("leaf_eval_kernel",)
# the leaf floor's micro-kernel: blocks x threads threads, four chains of
# OP_RATE_ITERS steps each (ops/leaf_eval.py::op_rate)
OP_RATE_BLOCKS, OP_RATE_THREADS, OP_RATE_ITERS = 132 * 8, 256, 1024
# the GV phase: slots, edges, levels and buckets of the order-6 sigma
# lowerings on the CPU, the source export's limit, and the share of a pass's
# busy time the profiler's phases must hold
GV_SIGMA6 = {"fused": (27792, 133097, 5, 21), "bucketed": (43440, 148112, 6, 8)}
EXPORT_RTOL = 1e-12
# the gamma4 phase: each Gamma4 lowering's slots, edges, levels, buckets
# and ProdPlans, then its roots and leaves, as the CPU lowers it; the batch
# of each order's float32-against-float64 check; the artifacts each host
# child builds; the batches of the Monte-Carlo lines; the passes whose
# weight buffer holds more than 2^31 elements, held bit for bit against
# windows of WINDOW columns; how long the gamma4 phase waits for a child
GAMMA4 = {(3, "fused"): ((1184, 5355, 10, 62, 0), (84, 180)),
          (3, "bucketed"): ((2854, 6579, 12, 30, 18), (84, 179)),
          (5, "fused"): ((44144, 272806, 16, 164, 0), (330, 3345)),
          (5, "bucketed"): ((130132, 342953, 21, 95, 43), (330, 3344)),
          (6, "fused"): ((229856, 1462003, 20, 211, 0), (546, 11768)),
          (6, "bucketed"): ((685472, 1851880, 26, 128, 55), (546, 11767))}
GAMMA4_CHECK_BATCH = {3: 4096, 5: 4096, 6: 512}
GAMMA4_CHILDREN = {5: ("fused", "bucketed", "config5", "certify8"), 6: ("fused", "bucketed")}
GAMMA4_MC = {(3, "fused"): (4096, 16384), (3, "bucketed"): (4096, 16384),
             (5, "fused"): (4096, 16384), (5, "bucketed"): (4096, 16384),
             (6, "fused"): (4096, 16384), (6, "bucketed"): (4096,)}
BIG_PASSES = ((5, "fused", 65536), (5, "bucketed", 32768), (6, "fused", 16384),
              (6, "bucketed", 4096))
WINDOW = 512
CHILD_TIMEOUT = 900
MC_RUN_MS = 400.0       # the least length of a timed Monte-Carlo run, where passes are long
PROFILE_COVER = 0.85
# the jit phase: the Monte-Carlo batches of its captured cases, and the host's
# calls timed behind a sleep kernel of JIT_SLEEP_CYCLES (few enough that the
# launch queue never fills while the device sleeps)
JIT_MC_BATCHES = (4096, 8192, 16384)
JIT_HOST_CALLS, JIT_SLEEP_CYCLES = 3, 2 ** 28
RAGGED_BATCH = 4097     # no multiple of 4: rows lose their 16-byte alignment
# the jit sharded phase: the batches checked on the 2 x 2 graph x batch mesh
# (4098: 2049 columns a batch rank, no multiple of 4), the sample axis's
# batch a rank in its MC step, and the calls of a traced or timed run of the
# config-5 step, whose eager step lasts ~0.1 s
SHARD_2X2_BATCHES = (BATCH, BATCH + 2)
SAMPLE_MC_BATCH = 1024
C5_CALLS = 3
M = 2 ** 20
# (widest record in pieces, bytes a column group may touch): the kernel's
# launch geometry, None for what the wrapper picks
GEOMETRIES = (None, (4, 24 * M), (2, 24 * M), (1, 24 * M), (4, 6 * M), (4, 1024 * M))
# the JAX script's first two output values of each probe (on its data)
PROBE_FIRST = {"dma8": [704, 705], "dmagrp": [192, 193], "vmemrow": [704, 705],
               "vmem8": [704, 705], "acc": [2432, 2436], "onehot": [704, 705],
               "dynwrite": [0, 0], "dmadyn_dst": [632, 633], "take": [536, 537]}
BULK_CHUNKS = (256, 1024, 4096, 16384)   # bytes a block of the TMA copy variants moves
COPY_THREADS = (64, 128, 256)            # block sizes of the two copies' sweep
EMPTY_GRIDS = ((1, 32), (16, 128))       # (blocks, threads) of the empty kernel: the least
                                         # launch, and a thread per 16-byte piece of 8 rows
                                         # at B 512
BIG_COPY = (40000, 32768)                # S x B f32, 5.2 GB: byte offsets past 2^32
# the Hubbard atom's phase: beta, U, the orders the series knows, each
# order's levels that hold buckets or plans (the kernel's launches a pass), the batch
# of a pass, the Monte-Carlo chunks, and each order's stderr floor (as in
# tests/test_hubbard_atom.py; order 5 as order 4)
HUBBARD_BETA, HUBBARD_U = 2.3, 1.0
HUBBARD_ORDERS = (1, 2, 3, 4, 5)
HUBBARD_BUCKET_LEVELS = {1: 2, 2: 5, 3: 9, 4: 13, 5: 17}
HUBBARD_BATCH, HUBBARD_CHUNKS = 65536, 16
HUBBARD_FLOOR = {2: 1e-4, 3: 3e-4, 4: 5e-4, 5: 5e-4}
ORDER1_REL = 1e-6       # order 1 against -U/2, float32: relative, and absolute for Im
# the ED oracle's phase (as tests/test_atom_ed.py): taus of the U=0 atom's
# g_tau, its bound against the free kernel and against the CPU, the (U, mu,
# beta) of the self-energy checks and of the dimer's hopping identity
ED_TAUS, ED_RTOL = 65536, 1e-12
ED_SIGMA_CASES = ((1.0, 0.0, 1.0), (2.5, 0.6, 0.8), (4.0, -0.3, 1.5))
ED_HOP = (2.0, 0.3, 1.2)
DYNWRITE_ROWS = (-16, -7, 2, 259, 1028, -3, 14, 2 ** 31 - 1, -2 ** 31)   # r mod 8 = 0..7, 0
PROBE_LINE = {"dma8": 39, "dmagrp": 61, "vmemrow": 82, "vmem8": 100, "acc": 122,
              "onehot": 143, "dynwrite": 162, "dmadyn_dst": 185, "take": 205}


# the launch plan's phase: its cases' batches, the eager calls a side a turn
# of its dispatch timing (a pool of PLAN_POOL host batches, as the benchmark's
# call cell), and the host-only clock's calls and repeats
PLAN_BATCHES = {"order-4 Gamma4 fused": 4096, "config 4 fused": 8192}
# the column-run phase: each case's batches
COLUMN_RUN_CASES = {"order-4 Gamma4 fused": (4096, 4097, 16384),
                    "config 4 fused": (8192, 16384), "gvsigma6-ct series": (4096, 8192, 16384)}
PLAN_CALLS, PLAN_POOL = 200, 16
PLAN_HOST_CALLS, PLAN_HOST_REPS = 20, 5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    print(f"chip_smoke: the run failed after {time.perf_counter() - STARTED:.1f} s",
          file=sys.stderr, flush=True)
    sys.exit(1)


def union_length(intervals) -> float:
    """The length of the union of intervals (start, end): the time in which
    at least one of them runs."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def probe_library_calls(w, rows):
    """The one PyTorch call that computes each row-access probe's function
    on the probe's ``w`` and int32 ``rows``: name -> a call of no arguments.
    The host's row arithmetic and the index tensors are made here, before
    any call.  Timed beside the kernels; nothing in the port calls them."""
    import torch
    import torch.nn.functional as F
    from feynmandiagram_tpu_torch.benchmarks import probe_mosaic_caps as pm
    r = [int(x) for x in rows.tolist()]
    dev, blk = w.device, w[:pm.BLOCK_ROWS]
    k = blk.shape[0]
    s1, s8, g8, j8, d0 = (pm._slice_start(r[0], k, 1), pm._slice_start(r[0], k, 8),
                          8 * (r[0] // 8), r[0] % 8, 8 * r[0])
    sel = (torch.arange(k, device=dev)[None, :]
           == r[0] + torch.arange(8, device=dev)[:, None]).to(w.dtype)
    acc_rows = torch.tensor([pm._slice_start(x, k, 1) for x in r], device=dev)
    bag = torch.zeros(1, dtype=torch.long, device=dev)   # one bag: the four rows
    take_rows = torch.tensor(pm.TAKE_ROWS, device=dev)
    # dmadyn_dst's 8 rows land in scratch[0:8] only where rows[1] mod 4 == 0
    dyn_dst = ((lambda: w[d0:d0 + 8].clone()) if r[1] % 4 == 0 else
               (lambda: torch.zeros((8, w.shape[1]), dtype=w.dtype, device=dev)))
    return {"dma8": lambda: w[r[0]:r[0] + 8].clone(),
            "dmagrp": lambda: w[g8:g8 + 8].clone(),
            "vmemrow": lambda: blk[s1:s1 + 1].clone(),
            "vmem8": lambda: blk[s8:s8 + 8].clone(),
            "acc": lambda: F.embedding_bag(acc_rows, blk, bag, mode="sum"),
            "onehot": lambda: torch.matmul(sel, blk),
            "dynwrite": lambda: F.pad(blk[0:1], (0, 0, j8, 7 - j8)),
            "dmadyn_dst": dyn_dst,
            "take": lambda: torch.index_select(blk, 0, take_rows)}


def launch_plan_checks(dev, smi: str, cases) -> dict:
    """``launch plan:`` lines.  For each case ``(label, compiled, n_loop,
    n_tau)`` at its batch of PLAN_BATCHES: the graph phase from the launch
    plan (each run of levels one ``levels_gather_reduce``) against the
    level-by-level path (``Evaluator.steps`` None: a checked
    ``level_gather_reduce`` a level) bit for bit, in float32, float32 with
    float64 accumulation and float32 compensated, three passes each, with
    the level launches, the run launcher's calls and share of them, and the
    plans built (one); the whole eager call through the plan against the
    call before it (the leaf phase through the checked ``leaf_eval``, the
    levels one by one) bit for bit; then both calls' clocks in turns: the
    host's dispatch (samples handed over to the entry's return) and the
    call (roots read back into the caller's host array) over PLAN_CALLS
    calls a turn on PLAN_POOL host batches, and the host's time alone (calls
    queued behind a sleep kernel, samples on the card) of the call, its
    leaf phase and its graph phase."""
    import numpy as np
    import torch
    from feynmandiagram_tpu_torch.backends.compile import CompiledEvaluator, eager_pass
    from feynmandiagram_tpu_torch.ops import evaluator as evaluator_mod
    from feynmandiagram_tpu_torch.ops import kernels, leaf_eval
    from feynmandiagram_tpu_torch.ops.evaluator import level_buckets, make_evaluator
    from feynmandiagram_tpu_torch.utils.profiling import scope

    level_fn, run_fn = kernels.level_gather_reduce, kernels.levels_gather_reduce
    col_fn = kernels.column_run_gather_reduce
    rng = np.random.default_rng(SEED)

    def host_ms(fn):
        """The host's ms a call of fn, PLAN_HOST_CALLS calls queued behind a
        sleep kernel, the median of PLAN_HOST_REPS; None where the device
        woke before the host was done."""
        fn()
        out = []
        for _ in range(PLAN_HOST_REPS):
            torch.cuda.synchronize()
            torch.cuda._sleep(JIT_SLEEP_CYCLES)
            slept = torch.cuda.Event()
            slept.record()
            t0 = time.perf_counter()
            for _ in range(PLAN_HOST_CALLS):
                fn()
            out.append((time.perf_counter() - t0) / PLAN_HOST_CALLS * 1e3)
            if slept.query():
                out[-1] = math.nan
        torch.cuda.synchronize()
        med = float(np.median(out))
        return None if math.isnan(med) else med

    def per_level(lowered):
        g = make_evaluator(lowered, device=dev, dtype=torch.float32)
        g.steps = None
        return g

    report = {}
    for label, c, n_loop, n_tau in cases:
        batch = PLAN_BATCHES[label]
        n_levels = sum(1 for lvl in c.lowered.levels if level_buckets(lvl))
        pool = [(torch.from_numpy(rng.standard_normal((3, n_loop, batch), dtype=np.float32)),
                 torch.from_numpy(rng.random((n_tau, batch), dtype=np.float32)
                                  * np.float32(BETA))) for _ in range(PLAN_POOL)]
        vk, vt = (x.to(dev) for x in pool[0])
        leaves = c.leaf_fn(vk, vt)
        rep = {"batch": batch, "levels": n_levels, "checks": {}}
        for name, acc, comp in (("float32", None, False), ("float32/float64", torch.float64,
                                                           False),
                                ("float32 compensated", None, True)):
            planned = make_evaluator(c.lowered, device=dev, dtype=torch.float32, acc_dtype=acc,
                                     compensated=comp)
            stepwise = make_evaluator(c.lowered, device=dev, dtype=torch.float32, acc_dtype=acc,
                                      compensated=comp)
            stepwise.steps = None
            runs = sum(1 for step in planned.steps if isinstance(step, list))
            built = evaluator_mod.launch_plan.built
            level_fn.launches = run_fn.launches = run_fn.calls = col_fn.levels = 0
            got = [planned(leaves) for _ in range(3)]
            counted = (level_fn.launches + col_fn.levels,
                       run_fn.launches + col_fn.levels, run_fn.calls,
                       evaluator_mod.launch_plan.built - built)
            level_fn.launches = col_fn.levels = 0
            want = stepwise(leaves)
            torch.cuda.synchronize()
            same = all(torch.equal(g, want) for g in got)
            share = counted[1] / max(counted[0], 1)
            print(f"launch plan: {label}, batch {batch} {name}: 3 passes from the launch plan "
                  f"against the level-by-level path bit for bit {same}; {counted[0]} levels "
                  f"launched, alone or in column runs ({n_levels} a pass expected), "
                  f"{counted[1]} of them from "
                  f"{counted[2]} run launcher calls ({runs} run(s) a pass; share "
                  f"{100 * share:.1f}%), {counted[3]} plan(s) built; the level-by-level pass "
                  f"{level_fn.launches} launches", flush=True)
            if not same or not torch.isfinite(want).all():
                fail(f"launch plan {label} {name}: the pass from the plan left the "
                     f"level-by-level one")
            if counted != (3 * n_levels, 3 * n_levels, 3 * runs, 1) \
                    or level_fn.launches != n_levels:
                fail(f"launch plan {label} {name}: counted {counted} (level launches, of the "
                     f"run launcher, its calls, plans built), expected "
                     f"{(3 * n_levels, 3 * n_levels, 3 * runs, 1)}")
            rep["checks"][name] = {"bit_for_bit": same, "launches": counted[0],
                                   "launcher_share": share, "runs": runs,
                                   "plans_built": counted[3]}
            del planned, stepwise, got, want
        plan = c.leaf_fn.plan

        def leaf_before(varK, varT, out):
            """The leaf phase as a call ran it before the plan: every check
            of ``leaf_eval`` at each call."""
            with scope("inputs"):
                varK = torch.as_tensor(varK, device=dev).contiguous()
                varT = torch.as_tensor(varT, device=dev).contiguous().to(varK.dtype)
            with scope("leaf"):
                leaf_eval.leaf_eval(plan, varK, varT, out)
            return out

        g_before = per_level(c.lowered)
        before = CompiledEvaluator(c.lowered, c.tables, eager_pass(leaf_before, g_before),
                                   leaf_before, g_before, c.max_loop_num)
        same = torch.equal(c(*pool[1]), before(*pool[1]))
        print(f"launch plan: {label}, batch {batch} f32, the eager call (host samples) through "
              f"the plans against the call before them: bit for bit {same}", flush=True)
        if not same:
            fail(f"launch plan {label}: the eager call left the call before the plan")
        kept = [c(*p).cpu() for p in pool]
        clocks = {"before": {"dispatch": [], "call": []}, "plan": {"dispatch": [], "call": []}}
        for mode in ("before", "plan", "plan", "before"):
            fn = c if mode == "plan" else before
            for i in range(PLAN_CALLS):
                j = i % PLAN_POOL
                a = time.perf_counter()
                roots = fn(*pool[j])
                b = time.perf_counter()
                kept[j].copy_(roots)
                e = time.perf_counter()
                clocks[mode]["dispatch"].append(1e3 * (b - a))
                clocks[mode]["call"].append(1e3 * (e - a))
        w_plan, w_before = c.graph_fn.buffer(batch), g_before.buffer(batch)
        w_plan[:c.graph_fn.nl_input] = leaves
        w_before[:g_before.nl_input] = leaves
        out = torch.empty_like(leaves)
        host = {"plan": {"call": host_ms(lambda: c(vk, vt)),
                         "leaf": host_ms(lambda: c.leaf_fn(vk, vt, out=out)),
                         "graph": host_ms(lambda: c.graph_fn.run(w_plan))},
                "before": {"call": host_ms(lambda: before(vk, vt)),
                           "leaf": host_ms(lambda: leaf_before(vk, vt, out)),
                           "graph": host_ms(lambda: g_before.run(w_before))}}
        stats = {mode: {k: {"median": float(np.median(v)),
                            "p95": float(np.percentile(v, 95))} for k, v in m.items()}
                 for mode, m in clocks.items()}
        saved = (host["before"]["graph"] - host["plan"]["graph"]) / n_levels \
            if host["before"]["graph"] is not None and host["plan"]["graph"] is not None \
            else None

        def ms(x):
            return "n/a" if x is None else f"{x:.4f}"

        print(f"launch plan time: {label}, batch {batch} f32, before / plan, {2 * PLAN_CALLS} "
              f"eager calls a side in turns on {PLAN_POOL} host batches: dispatch median "
              f"{stats['before']['dispatch']['median']:.4f} / "
              f"{stats['plan']['dispatch']['median']:.4f} ms, call median "
              f"{stats['before']['call']['median']:.4f} / {stats['plan']['call']['median']:.4f} "
              f"ms, call p95 {stats['before']['call']['p95']:.4f} / "
              f"{stats['plan']['call']['p95']:.4f} ms; the host alone (samples on the card, "
              f"queued behind a sleep): call {ms(host['before']['call'])} / "
              f"{ms(host['plan']['call'])} ms, leaf phase {ms(host['before']['leaf'])} / "
              f"{ms(host['plan']['leaf'])} ms, graph phase {ms(host['before']['graph'])} / "
              f"{ms(host['plan']['graph'])} ms ({n_levels} levels: "
              f"{ms(None if saved is None else 1e3 * saved)} us saved a level)  [{smi}]",
              flush=True)
        rep.update({"call_bit_for_bit": same, "clocks": stats, "host_ms": host,
                    "saved_us_per_level": None if saved is None else 1e3 * saved})
        report[label] = rep
        del before, g_before, kept, pool, leaves, w_plan, w_before, out
        torch.cuda.empty_cache()
    return report


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
    import numpy as np
    import torch

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


def column_run_cases(dev, built=None):
    """The column-run phase's cases: ``(label, compiled, n_loop, n_tau)`` of
    order-4 Gamma4 fused, config 4 fused and the renormalized GV
    self-energy to order 6 (``diagsGV_series``), float32; those that
    ``built`` (label -> ``(compiled, n_loop, n_tau)``) holds are taken from
    it, the others built here."""
    import torch
    from feynmandiagram_tpu_torch.backends import compile_evaluator
    from feynmandiagram_tpu_torch.benchmarks.bench_config4 import config4_roots
    from feynmandiagram_tpu_torch.benchmarks.gamma4_orders import vertex4_roots
    from feynmandiagram_tpu_torch.frontends import NoHartree
    from feynmandiagram_tpu_torch.frontends.gv import diagsGV_series

    out = []
    for label in COLUMN_RUN_CASES:
        if label in (built or {}):
            out.append((label, *built[label]))
            continue
        if label == "order-4 Gamma4 fused":
            roots, para = vertex4_roots(4)
            n_loop, n_tau = para.totalLoopNum, para.totalTauNum
        elif label == "config 4 fused":
            roots, para, _ = config4_roots(4)
            n_loop, n_tau = para.totalLoopNum, para.totalTauNum
        else:
            roots, _, n_loop, n_tau = diagsGV_series("sigma", 6, filter=(NoHartree,),
                                                     spin_polar_para=0.0)
        c = compile_evaluator(roots, max_loop_num=n_loop, beta=BETA, kF=KF, lam=LAM,
                              device=dev, dtype=torch.float32, sum_mode="fused")
        out.append((label, c, n_loop, n_tau))
    return out


def stretch_rows(run):
    """``(outside, written)``, sorted arrays: the distinct rows of ``w``
    that a column run reads as they were before its launch (not yet
    written by an earlier level of its stretch), and the rows it writes.
    One launch moves those rows at the least."""
    import numpy as np
    from feynmandiagram_tpu_torch.ops import kernels

    rec, g = run.host_rows, kernels.RUN_GATHERS
    n_g = rec[:, 1]
    outside, written = set(), set()
    bounds = run.level_rows.tolist()
    for r0, r1 in zip(bounds, bounds[1:]):
        read = [rec[r0:r1, 4:4 + g][np.arange(g) < n_g[r0:r1, None]]]
        read += [run.host_extra_idx[rec[i, 2]:rec[i, 2] + n_g[i] - g]
                 for i in range(r0, r1) if n_g[i] > g]
        outside |= set((np.concatenate(read) & 0x7fffffff).tolist()) - written
        written |= set(rec[r0:r1, 0].tolist())
    return np.array(sorted(outside), np.int64), np.array(sorted(written), np.int64)


def column_run_checks(dev, smi: str, cases) -> dict:
    """``column run:`` lines.  For each case ``(label, compiled, n_loop,
    n_tau)`` at each of its COLUMN_RUN_CASES batches, the graph phase on the
    leaves of one draw: the stretches that the launch plan cuts (each run
    of two or more consecutive thin levels one launch of
    ``column_run_gather_reduce_kernel``).  In the four (storage,
    accumulation) pairs, each plain and compensated: the eager pass from
    the plan against the level-by-level path (``Evaluator.steps`` None: a
    checked ``level_gather_reduce`` a level) bit for bit over the whole
    buffer, with the launch counters (level launches, column runs and the
    levels they computed, all levels once); then each stretch alone, from
    the buffer as the levels before it leave it (the lowering reuses rows,
    so the pass's final buffer will not do), the rows it writes and does
    not read first set to NaN: its column run against its plain version
    (``column_run_gather_reduce_plain``) and its levels' own launches, bit
    for bit over the whole buffer, every row it writes finite; the captured pass (``ops.graphs``) bit for bit
    against the level-by-level path, in float32 plain and compensated,
    with its manifest and a replay's counts.  Then, float32 (``column run
    time:``): the graph phase with and without column runs, and each
    stretch alone as one column run against its levels' own launches, its
    own bound (``stretch_rows``), the sum of its levels' byte bounds and
    its plain version."""
    import numpy as np
    import torch
    from feynmandiagram_tpu_torch.ops import kernels
    from feynmandiagram_tpu_torch.ops.evaluator import level_buckets, make_evaluator
    from feynmandiagram_tpu_torch.ops.graphs import capture, replay

    rng = np.random.default_rng(SEED)
    level_fn, run_fn, col = (kernels.level_gather_reduce, kernels.levels_gather_reduce,
                             kernels.column_run_gather_reduce)
    f32 = torch.float32
    stream = torch.cuda.current_stream().cuda_stream

    def bits(x):
        return x.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()])

    def zero_counts():
        level_fn.launches = col.launches = col.levels = 0
        run_fn.calls = run_fn.launches = 0

    def counts():
        return (level_fn.launches, col.launches, col.levels)

    def fill(ev, w, leaves):
        """The rows a pass reads before its levels: the leaves, the constants."""
        w[:ev.nl_input] = leaves.to(w.dtype)
        if ev.n_const:
            w[ev.nl_input:ev.nl_input + ev.n_const] = ev.const_values[:, None]

    def plan(ev, w, levels, apart=False):
        """The launch plan of ``levels`` of ev on w's shape; ``apart``: with
        no level thin, a launch a level."""
        thin = kernels.THIN_BYTES
        kernels.THIN_BYTES = 0 if apart else thin
        try:
            return kernels.plan_run(w, [lvl.tables for lvl in levels],
                                    [f"{lvl.scope}/{lvl.bucket_scope}" for lvl in levels],
                                    compensated=ev.compensated, acc_dtype=ev.acc_dtype)
        finally:
            kernels.THIN_BYTES = thin

    def stretches_of(ev, run):
        """``(path, first, levels, column run)`` of each stretch of run,
        ev's one run of levels, ``first`` the index of its first level."""
        levels, out, first = ev.steps[0], [], 0
        for path, n in zip(run.paths, run.table[:, 5].tolist()):
            if n:
                out.append((path, first, levels[first:first + n], run.column_runs[len(out)]))
            first += max(n, 1)
        return out

    report = {}
    for label, c, n_loop, n_tau in cases:
        n_levels = sum(1 for lvl in c.lowered.levels if level_buckets(lvl))
        for batch in COLUMN_RUN_CASES[label]:
            vk = torch.as_tensor(rng.standard_normal((3, n_loop, batch), dtype=np.float32),
                                 device=dev)
            vt = torch.as_tensor(rng.random((n_tau, batch), dtype=np.float32)
                                 * np.float32(BETA), device=dev)
            leaves = c.leaf_fn(vk, vt)
            probe = make_evaluator(c.lowered, device=dev, dtype=f32)
            if len(probe.steps) != 1 or not isinstance(probe.steps[0], list):
                fail(f"column run {label}: the pass is not one run of levels")
            w = probe.buffer(batch)
            run = plan(probe, w, probe.steps[0])
            levels_of = run.table[:, 5].tolist()
            stretch = [(p, n) for p, n in zip(run.paths, levels_of) if n]
            n_level = sum(1 for n in levels_of if n == 0)
            print(f"column run: {label}, batch {batch} f32: {len(run.paths)} launches a pass, "
                  f"{n_level} level launches and {len(stretch)} column run(s) "
                  f"({', '.join(f'{p} of {n} levels' for p, n in stretch) or 'none'}) for "
                  f"{n_levels} levels", flush=True)
            if n_level + sum(n for _, n in stretch) != n_levels:
                fail(f"column run {label}, batch {batch}: the plan covers "
                     f"{n_level + sum(n for _, n in stretch)} of {n_levels} levels")
            rep = {"levels": n_levels, "stretches": [[p, n] for p, n in stretch],
                   "level_launches": n_level, "checks": {}}
            for storage, acc in ((f32, None), (torch.float64, None), (f32, torch.float64),
                                 (torch.bfloat16, f32)):
                for comp in (False, True):
                    name = (f"{str(storage)[6:]}/{str(acc or storage)[6:]}"
                            f"{' compensated' if comp else ''}")
                    ev = make_evaluator(c.lowered, device=dev, dtype=storage, acc_dtype=acc,
                                        compensated=comp)
                    ref = make_evaluator(c.lowered, device=dev, dtype=storage, acc_dtype=acc,
                                         compensated=comp)
                    ref.steps = None
                    w0 = ev.buffer(batch)
                    fill(ev, w0, leaves)
                    w1 = w0.clone()
                    own = plan(ev, w0, ev.steps[0])     # the stretches at this element size
                    own_levels = own.table[:, 5].tolist()
                    want_counts = (sum(1 for n in own_levels if n == 0),
                                   sum(1 for n in own_levels if n), sum(own_levels))
                    own_runs = ", ".join(p for p, n in zip(own.paths, own_levels) if n)
                    zero_counts()
                    ev.eval_levels(w0)
                    got = counts()
                    ref.eval_levels(w1)
                    torch.cuda.synchronize()
                    same = torch.equal(bits(w0), bits(w1))
                    # each stretch alone, from the buffer as the levels
                    # before it leave it, the rows it writes but does not
                    # read first set to NaN: its column run against its
                    # plain version and its levels' own launches
                    plain_same = []
                    for _, first, part, colrun in stretches_of(ev, own):
                        pre = w1.clone()
                        fill(ev, pre, leaves)
                        if first:
                            kernels.levels_gather_reduce(
                                pre, plan(ev, pre, ev.steps[0][:first], apart=True), stream)
                        outside, written = stretch_rows(colrun)
                        poison = torch.as_tensor(np.setdiff1d(written, outside), device=dev)
                        pre[poison] = float("nan")
                        wl, wp = pre.clone(), pre.clone()
                        kernels.levels_gather_reduce(pre, plan(ev, pre, part), stream)
                        kernels.levels_gather_reduce(wl, plan(ev, wl, part, apart=True), stream)
                        kernels.column_run_gather_reduce_plain(wp, colrun, compensated=comp,
                                                               acc_dtype=acc)
                        torch.cuda.synchronize()
                        plain_same.append(torch.equal(bits(pre), bits(wp))
                                          and torch.equal(bits(pre), bits(wl))
                                          and bool(torch.isfinite(pre[poison]).all()))
                        del pre, wl, wp
                    check = {"eager_bit_for_bit": same, "counts": list(got),
                             "column_runs": own_runs.split(", ") if own_runs else [],
                             "plain_bit_for_bit": plain_same,
                             "finite": bool(torch.isfinite(w1[ref.root_slots]).all())}
                    line = (f"column run: {label}, batch {batch} {name}: the eager pass from the "
                            f"plan against the level-by-level path, the whole buffer bit for bit "
                            f"{same}; launches counted (level, column runs, their levels) "
                            f"{got}, expected {want_counts} (column runs: "
                            f"{own_runs or 'none'}); each column run alone, from the buffer "
                            f"the levels before it leave, against its plain version and its "
                            f"levels' own launches, the whole buffer bit for bit and its rows "
                            f"written {plain_same or 'none'}")
                    if not same or got != want_counts or not all(plain_same):
                        fail(line)
                    if storage == f32 and acc is None:
                        sp = ev.static_pass(batch)
                        sp.leaves.copy_(leaves)
                        graph, out = capture(sp.run)
                        manifest = [(x.symbol, x.path, x.levels) for x in graph.manifest
                                    if x.kernel in (level_fn, col)]
                        zero_counts()
                        replay(graph, 2)
                        torch.cuda.synchronize()
                        replayed = counts()
                        cap_same = torch.equal(bits(out), bits(w1[ref.root_slots]))
                        want_manifest = [(col.symbol if n else level_fn.symbol, p, max(n, 1))
                                         for p, n in zip(own.paths, own_levels)]
                        check.update({"captured_bit_for_bit": cap_same,
                                      "replay_counts": list(replayed)})
                        planned = manifest == want_manifest
                        line += (f"; captured: roots after 2 replays bit for bit {cap_same}, "
                                 f"manifest {'as planned' if planned else manifest}, 2 replays "
                                 f"counted {replayed}")
                        if not cap_same or not planned \
                                or replayed != tuple(2 * x for x in want_counts):
                            fail(line)
                        del graph, out, sp
                    print(line, flush=True)
                    rep["checks"][name] = check
                    del ev, ref, w0, w1, own
                    torch.cuda.empty_cache()
            # times, float32
            fill(probe, w, leaves)
            off = plan(probe, w, probe.steps[0], apart=True)

            def timed(r):
                # the launches queued behind one sleep stay well inside the
                # device's queue of pending launches
                reps = max(1, min(40, int(2e5 / batch), 400 // len(r.paths)))
                return queued_ms(lambda: kernels.levels_gather_reduce(w, r, stream), n=reps)

            t_on, t_off = timed(run), timed(off)
            per = []
            for path, _, part, colrun in stretches_of(probe, run):
                read, written = map(len, stretch_rows(colrun))
                w_plain = w.clone()
                kernels.column_run_gather_reduce_plain(w_plain, colrun)
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                kernels.column_run_gather_reduce_plain(w_plain, colrun)
                e1.record()
                torch.cuda.synchronize()
                per.append({"stretch": path, "levels": len(part),
                            "column_run_ms": timed(plan(probe, w, part)),
                            "level_launches_ms": timed(plan(probe, w, part, apart=True)),
                            "bound_ms": (read + written) * batch * 4 / HBM_BYTES_PER_S * 1e3,
                            "rows_read": read, "rows_written": written,
                            "level_bounds_ms": sum(lvl.tables.rows_touched for lvl in part)
                            * batch * 4 / HBM_BYTES_PER_S * 1e3,
                            "plain_ms": e0.elapsed_time(e1)})
                del w_plain
            print(f"column run time: {label}, batch {batch} f32: the graph phase with / without "
                  f"column runs {t_on:.4f} / {t_off:.4f} ms ({t_off / t_on:.2f}x); "
                  + "; ".join(f"{x['stretch']} ({x['levels']} levels) alone: one column run "
                              f"{x['column_run_ms']:.4f} ms, its level launches "
                              f"{x['level_launches_ms']:.4f} ms, its own bound "
                              f"{x['bound_ms']:.4f} ms ({x['rows_read']} rows read from "
                              f"outside, {x['rows_written']} written; "
                              f"{x['bound_ms'] / x['column_run_ms']:.2f} of it), its levels' "
                              f"bounds summed {x['level_bounds_ms']:.4f} ms, its plain "
                              f"version {x['plain_ms']:.4f} ms (one call, events)"
                              for x in per)
                  + f"  [{smi}]", flush=True)
            rep.update({"graph_ms": t_on, "graph_ms_without": t_off, "stretch_times": per})
            report[f"{label} {batch}"] = rep
            del probe, w, run, off, leaves, vk, vt
            torch.cuda.empty_cache()
    return report


def column_run_main() -> None:
    """``python3 chip_smoke.py --column-runs``: the card, the level kernel's
    build and the column-run phase alone."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.modules["jax"] = None
    sys.modules["feynmandiagram_tpu"] = None
    from feynmandiagram_tpu_torch.benchmarks import card_name
    from feynmandiagram_tpu_torch.ops import build

    smi = card_name()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    for name in ("bucket_gather_reduce", "leaf_eval"):
        build.build(name)
    print(f"build: bucket_gather_reduce, leaf_eval in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cases = column_run_cases(dev)
    print(f"column run: cases built in {time.perf_counter() - t0:.1f} s", flush=True)
    report = column_run_checks(dev, smi, cases)
    print(f"chip_smoke: the whole run took {time.perf_counter() - STARTED:.1f} s", flush=True)
    print(json.dumps({"column_runs": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0)}}),
          flush=True)


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
    from feynmandiagram_tpu_torch.mc import CapturedLoop, mc_run, mc_samples_per_s
    from feynmandiagram_tpu_torch.backends.compile import leafmap_of
    from feynmandiagram_tpu_torch.benchmarks import card_name, median_ms, probe_gather
    from feynmandiagram_tpu_torch.benchmarks import probe_mosaic_caps as pm
    from feynmandiagram_tpu_torch.ops import build, kernels, leaf_eval
    from feynmandiagram_tpu_torch.ops.evaluator import level_buckets, make_evaluator
    from feynmandiagram_tpu_torch.ops.lowering import lower
    from feynmandiagram_tpu_torch.ops.leaf_eval import make_leaf_evaluator

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_fn, plain_fn = kernels.bucket_gather_reduce, kernels.bucket_gather_reduce_plain
    level_fn, level_plain = kernels.level_gather_reduce, kernels.level_gather_reduce_plain
    col_fn = kernels.column_run_gather_reduce

    def zero_levels():
        """Zero the counts of the levels launched: alone, and in column runs."""
        level_fn.launches = col_fn.launches = col_fn.levels = 0

    def levels_run():
        """The levels launched since zero_levels: each level's own launches
        and the levels that column runs computed."""
        return level_fn.launches + col_fn.levels

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
    with ThreadPoolExecutor(4) as pool:
        host_lib = pool.submit(native.native_available)
        list(pool.map(build.build, ("bucket_gather_reduce", "leaf_eval", "row_probes")))
        host_path = "native graphcore library (g++)" if host_lib.result() else "numpy path"
    print(f"build: bucket_gather_reduce, leaf_eval, row_probes (nvcc) and graphcore (g++) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"host: CSE and levelling of the lowering run on the {host_path}", flush=True)

    # the Gamma4 orders 5 and 6 are generated, optimized and lowered on the
    # host in child processes (benchmarks/gamma4_orders.py), which run beside
    # the phases below and touch no CUDA; the gamma4 phase loads what they
    # wrote.  Each child and what it forked is killed at exit
    import atexit
    import shutil
    import signal
    import subprocess
    import tempfile
    g4_dir = tempfile.mkdtemp(prefix="gamma4_")
    child_cmd = ("import sys; sys.modules['jax'] = None; sys.modules['feynmandiagram_tpu'] = None; "
                 "from feynmandiagram_tpu_torch.benchmarks.gamma4_orders import main; main()")
    g4_children = {}
    for order, artifacts in GAMMA4_CHILDREN.items():
        log = open(os.path.join(g4_dir, f"o{order}.log"), "w")
        g4_children[order] = (subprocess.Popen(
            [sys.executable, "-c", child_cmd, str(order), g4_dir, "--artifacts",
             ",".join(artifacts)], cwd=repo, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES=""),
            start_new_session=True), log, time.perf_counter())

    def stop_children():
        for proc, log, _ in g4_children.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:     # the child and all it forked are gone
                pass
            proc.wait()
            log.close()
        shutil.rmtree(g4_dir, ignore_errors=True)

    atexit.register(stop_children)
    print(f"host: Gamma4 orders {', '.join(map(str, GAMMA4_CHILDREN))} started in child "
          f"processes", flush=True)
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
        """The packed tables of every level of low that holds buckets or plans."""
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

    def leaf_launches():
        """The launch count of the leaf kernel."""
        return leaf_eval.leaf_eval.launches

    def check_slice(c, samples, label, names=None, diagnose=None, misses=None):
        """The float32 pass of c through the kernel against the port's plain
        path in float64 on the card, on each (varK, varT) of samples: a
        pass must launch the kernel once per level that holds buckets or plans and
        never bucket by bucket, and each root's max|d|/max|ref| must be
        within SLICE_TOL (names: each root's name in the failure;
        diagnose(c, varK, varT, root, ref) runs on a miss and returns a dict
        of what it found).  A miss fails the run here, or, given the list
        misses, is added to it as a dict and fails the run at its end.
        Returns the levels that hold buckets or plans and, per batch, (each root's
        error, max|d|/max|ref| over all roots)."""
        n_levels = sum(1 for lvl in c.lowered.levels if level_buckets(lvl))
        n_roots = len(c.lowered.root_slots)
        ref_leaf = make_leaf_evaluator(c.tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                                       dtype=torch.float64)
        ref_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float64, kernel=False)
        out = {}
        for vk, vt in samples:
            batch = vt.shape[-1]
            ref = ref_graph(ref_leaf(vk, vt))
            torch.cuda.synchronize()
            kernel_fn.launches = 0
            zero_levels()
            leaf_eval.leaf_eval.launches = 0
            got = c(vk, vt)
            torch.cuda.synchronize()
            if levels_run() != n_levels or kernel_fn.launches != 0:
                fail(f"{label}, batch {batch}: {levels_run()} level and "
                     f"{kernel_fn.launches} bucket launches in a pass, expected {n_levels} (one "
                     f"per level that holds buckets or plans) and 0")
            if leaf_launches() != 1:
                fail(f"{label}, batch {batch}: the leaf kernel launched {leaf_launches()} "
                     f"times in a pass, expected once")
            if got.shape != (n_roots, batch) or not torch.isfinite(got).all():
                fail(f"{label}, batch {batch}: output not finite or of shape {tuple(got.shape)}")
            d = (got.double() - ref).abs()
            rel = (d.max(dim=1).values / ref.abs().max(dim=1).values).tolist()
            out[batch] = (rel, (d.max() / ref.abs().max()).item())
            k = int(np.argmax(rel))
            if not rel[k] <= SLICE_TOL:
                found = {} if diagnose is None else diagnose(c, vk, vt, k, ref)
                miss = (f"{label}, batch {batch}: per-root scale-relative error {rel[k]:.3e} > "
                        f"{SLICE_TOL} at root {k} {'' if names is None else names[k]}")
                if misses is None:
                    fail(miss)
                misses.append({"check": label, "batch": batch, "root": k,
                               "max_rel_err": rel[k], "limit": SLICE_TOL, **found})
                print(f"MISS: {miss}; the run goes on and fails at its end", flush=True)
        return n_levels, out

    # -- 4. the slice
    n_tau = para.totalTauNum
    varK = gen.standard_normal((3, para.totalLoopNum, BATCH))
    varT = gen.random((n_tau, BATCH)) * BETA
    launches = {}
    jit_keep = {}   # evaluators that the jit phase runs captured: label -> (compiled, para)
    for mode in ("fused", "bucketed"):
        n_levels, errs = check_slice(compiled[mode], [(varK, varT)], f"{mode} slice")
        launches[mode] = n_levels
        if mode == "fused":    # the main path's pass: each leaf kernel's launches
            leaf_main = leaf_launches()
        rel, scale_err = errs[BATCH]
        print(f"slice: {mode} f32 kernel vs f64 plain on the card, batch {BATCH}: "
              f"{n_levels} kernel launches per pass ({len(buckets_of(compiled[mode].lowered))} "
              f"buckets in {n_levels} levels), max|d|/max|ref| {scale_err:.3e}, worst per-root "
              f"{max(rel):.3e} (limit {SLICE_TOL:g})", flush=True)

    phase("slices")

    # clocks of the card, for phases 4b on
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

    lead_names = set()

    def kernel_names(fn):
        """The names of the device work of PROFILE_LEAD calls of fn."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA") and not e.is_user_annotation}
        if not names:
            fail("the profiler saw no kernel of torch.cuda._sleep")
        return names

    def profile_calls(fn, n=10):
        """The profiler's device time per call of fn, by kernel name, for
        calls that wait for the device or copy from the host (the
        Monte-Carlo pass, the probes' plain versions): each kernel's own
        time summed over n calls, after one untraced call; the level
        kernels a call, counted by name (a CUDA graph's replay launches
        kernels that no launch counter sees); the leaf kernels a call by
        name (LEAF_KERNELS, in order); the device's busy time a call, the
        union of the kernels' intervals in the trace; and the wall of a
        call in that same run, CUDA events around the n traced calls, which
        the busy time must not exceed (the callers check it).  Each trace
        starts with PROFILE_LEAD sleep kernels, left out of what it returns:
        the profiler on the card drops the first kernel records of a trace.
        The host idles 10 ms at each end of the trace; a trace without
        device time is taken again, up to TRACE_TRIES times."""
        if not lead_names:   # the sleep kernel's names, from a trace of its own
            lead_names.update(kernel_names(lambda: torch.cuda._sleep(1)))
        for _ in range(TRACE_TRIES):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_LEAD):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                time.sleep(0.01)
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                for _ in range(n):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                time.sleep(0.01)

            # the hot path's profiler scopes show on the device as annotation
            # spans over their kernels: those are not kernels
            def kernel(e):
                return (str(e.device_type).endswith("CUDA") and not e.is_user_annotation
                        and e.key not in lead_names)

            events = [e for e in prof.key_averages() if kernel(e)]
            by_kernel = {e.key: getattr(e, "self_device_time_total", 0) / n / 1e3
                         for e in events}
            busy = union_length((e.time_range.start, e.time_range.end)
                                for e in prof.events() if kernel(e)) / n / 1e3
            if busy > 0:
                return by_kernel, sum(e.count for e in events
                                      if "gather_reduce_kernel" in e.key) / n, tuple(
                    sum(e.count for e in events if k in e.key) / n for k in LEAF_KERNELS), \
                    busy, e0.elapsed_time(e1) / n
        fail(f"the profiler saw no device time in {TRACE_TRIES} traces")

    def device_ms_by_kernel(fn, n=10):
        """profile_calls' device time per call by kernel name."""
        return profile_calls(fn, n)[0]

    def busy_ms(fn, n=10):
        """The profiler's device busy time per call of fn (profile_calls)."""
        return profile_calls(fn, n)[3]

    def level_bounds(low, batch, elsize):
        """Per level that holds buckets or plans, the least time the card could take
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

    def level_pass_ms(low, w, tabs):
        """Device time of low's level launches on w (tabs: their packed
        tables): back to back (queued_ms, the mean of a reading before and
        one after the per-level run), per level (queued_each_ms), and each
        level's level_bounds."""
        levels = [lambda t=t: level_fn(w, t) for t in tabs]
        ld1, per_level, ld2 = (queued_ms(lambda: [fn() for fn in levels]),
                               queued_each_ms(levels),
                               queued_ms(lambda: [fn() for fn in levels]))
        return (ld1 + ld2) / 2, per_level, level_bounds(low, w.shape[1], w.element_size())

    def levels_line(label, per_level, bounds):
        """One line: each level's device time beside its bound."""
        print(f"{label}, per level: device us / bound us (share), rows read distinct + written "
              f"(gathers requested): " + "; ".join(
                  f"L{k} {1e3 * t:.1f}/{1e3 * b['ms']:.1f} ({b['ms'] / t:.2f}) "
                  f"{b['rows'][0]}+{b['rows'][1]} ({b['rows'][2]})"
                  for k, (t, b) in enumerate(zip(per_level, bounds)))
              + f"; sum {1e3 * per_level.sum():.1f} us  [{smi}]", flush=True)

    def mc_lines(c, para, batches, label):
        """Monte-Carlo samples/s of c's float32 pass at each batch, one line
        each: the level launches of a pass (over three passes of mc_run they
        must be the levels that hold buckets or plans, none bucket by bucket), the
        wall of one pass untraced, the profiler's device busy time (beside
        the kernels' own times summed) and the wall of the same traced
        passes (profile_calls), the idle share 1 -
        busy / that wall, and the level launches' share of busy.  A busy time
        above the wall of its own run is a faulty clock reading and fails.
        A run of mc_samples_per_s is 100 passes, or as many as last
        MC_RUN_MS where a pass is longer (at least 10)."""
        n_levels = sum(1 for lvl in c.lowered.levels if level_buckets(lvl))
        out = {}
        for batch in batches:
            mc_kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=batch,
                         n_roots=len(c.lowered.root_slots), device=dev, dtype=torch.float32,
                         beta=BETA)

            def one():
                mc_run(c.fn, iters=1, seed=SEED, **mc_kw)

            kernel_fn.launches = 0
            zero_levels()
            leaf_eval.leaf_eval.launches = 0
            mc_run(c.fn, iters=3, seed=SEED, **mc_kw)
            torch.cuda.synchronize()
            if levels_run() != 3 * n_levels or kernel_fn.launches != 0:
                fail(f"{label} mc_run: {levels_run()} level and {kernel_fn.launches} "
                     f"bucket launches in 3 passes, expected {3 * n_levels} and 0")
            if leaf_launches() != 3:
                fail(f"{label} mc_run: the leaf kernel launched {leaf_launches()} times in 3 "
                     f"passes, expected 3")
            by_kernel, _, _, busy, traced = profile_calls(one)
            level_busy = sum(t for k, t in by_kernel.items() if "gather_reduce_kernel" in k)
            wall = wall_ms(one, n=20)
            iters = min(100, max(10, int(MC_RUN_MS / wall)))
            sps = mc_samples_per_s(c.fn, iters=iters, reps=3, **mc_kw)
            print(f"{label} batch {batch} f32: {sps:.1f} samples/s ({iters} passes a run), "
                  f"{n_levels} level launches "
                  f"a pass; per pass wall {wall:.4f} ms, traced {traced:.4f} ms, device busy "
                  f"{busy:.4f} ms (idle share {1 - busy / traced:.3f}; the kernels' own times "
                  f"summed {sum(by_kernel.values()):.4f} ms), level launches "
                  f"{level_busy:.4f} ms ({level_busy / busy:.3f} of busy)  [{smi}]", flush=True)
            if busy > traced:
                fail(f"{label} batch {batch}: device busy {busy:.4f} ms above the wall "
                     f"{traced:.4f} ms of the same traced passes: a faulty clock reading")
            out[batch] = {"samples_per_s": sps, "busy_ms": busy, "wall_ms": wall,
                          "traced_wall_ms": traced, "level_busy_ms": level_busy,
                          "passes_a_run": iters}
        return out

    # -- 4'. the leaf kernel against its plain version, beside its bounds
    ULP_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
                torch.bfloat16: torch.int16}

    def ulps(k, p):
        """Elements of k that differ from p (one dtype: float32, float64 or
        bfloat16), and the largest difference in ulps: the distance of the
        two bit patterns, which counts ulps between values of one sign."""
        d = (k.view(ULP_VIEW[k.dtype]).long() - p.view(ULP_VIEW[p.dtype]).long()).abs()
        return int((k != p).sum()), int(d.max()) if d.numel() else 0

    def check_leaf_kernels(label, tables, n_loop, n_tau, item_leaves=leaf_eval.ITEM_LEAVES):
        """The leaf kernel against its plain version on the card, on the leaf
        tables of one lowering (its work list of item_leaves rows an item):
        batch BATCH with float32 samples (the Monte-Carlo path's) and
        RAGGED_BATCH with float64 samples, computing in float64 and in
        float32, the leaves stored in float32, float64 and bfloat16, on a
        buffer filled with NaN first.  Fails where an element differs by more than LEAF_ULPS
        ulps of its type or is not finite; returns the worst ulps, the
        elements that differ, those compared and the largest |kernel -
        plain|."""
        worst = {"ulps": 0, "differ": 0, "elements": 0, "max_abs_err": 0.0}
        for batch, in_dtype in ((BATCH, torch.float32), (RAGGED_BATCH, torch.float64)):
            vk = torch.randn((3, n_loop, batch), generator=dev_gen, device=dev).to(in_dtype)
            vt = (torch.rand((n_tau, batch), generator=dev_gen, device=dev) * BETA).to(in_dtype)
            for comp in (torch.float64, torch.float32):
                plan = leaf_eval.leaf_plan(tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                                           compute_dtype=comp, item_leaves=item_leaves)
                for store in (torch.float32, torch.float64, torch.bfloat16):
                    lp = torch.empty((plan.num_leaves, batch), dtype=store, device=dev)
                    leaf_eval.leaf_eval_plain(plan, vk, vt, lp)
                    lk = torch.full_like(lp, float("nan"))
                    leaf_eval.leaf_eval(plan, vk, vt, lk)
                    torch.cuda.synchronize()
                    n_diff, u = ulps(lk, lp)
                    err = (lk.double() - lp.double()).abs().max().item()
                    finite = bool(torch.isfinite(lk).all())
                    if u > LEAF_ULPS or not finite:
                        fail(f"leaf kernel: {label}, batch {batch}, {type_name(in_dtype)} "
                             f"samples, compute {type_name(comp)}, leaves in "
                             f"{type_name(store)}: {n_diff} elements differ from the plain "
                             f"version, by up to {u} ulps (limit {LEAF_ULPS}), max|diff| "
                             f"{err:.3e}, finite {finite}")
                    worst["ulps"] = max(worst["ulps"], u)
                    worst["differ"] += n_diff
                    worst["elements"] += lk.numel()
                    worst["max_abs_err"] = max(worst["max_abs_err"], err)
                    del lk, lp
            del vk, vt
        torch.cuda.empty_cache()
        print(f"leaf kernel: {label}: {tables.num_leaves} leaf rows, items of {item_leaves} "
              f"rows, kernel vs plain on the card at batch {BATCH} (float32 samples) and {RAGGED_BATCH} "
              f"(float64 samples), computing in float64 and float32, leaves stored in float32, "
              f"float64 and bfloat16: {worst['differ']} of {worst['elements']} elements differ, "
              f"worst {worst['ulps']} ulps of the element's type (limit {LEAF_ULPS}; bit for bit "
              f"expected: the plain version repeats the kernel's operations in order), max|diff| "
              f"{worst['max_abs_err']:.3e}", flush=True)
        return worst

    def op_rates():
        """The device time of one operation of the leaf phase, card-wide, per
        compute type (leaf_eval.RATE_OPS): queued_ms of op_rate over
        OP_RATE_BLOCKS x OP_RATE_THREADS threads of four chains of
        OP_RATE_ITERS steps, over the operations run; a conversion's chain
        also adds, whose time is taken off.  One line each, with the rate in
        operations a clock and SM at the card's highest SM clock."""
        import subprocess
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True, timeout=60).stdout.split()[0]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n_ops = OP_RATE_BLOCKS * OP_RATE_THREADS * 4 * OP_RATE_ITERS
        rates = {}
        for comp in (torch.float64, torch.float32):
            buf = torch.empty(OP_RATE_BLOCKS * OP_RATE_THREADS, dtype=comp, device=dev)
            ms = {op: queued_ms(lambda op=op: leaf_eval.op_rate(
                op, buf, OP_RATE_BLOCKS, OP_RATE_THREADS, OP_RATE_ITERS)) / n_ops
                for op in leaf_eval.RATE_OPS}
            if not torch.isfinite(buf).all():
                fail(f"leaf floor: the {type_name(comp)} micro-kernel left non-finite values")
            ms["cvt"] = max(ms["cvt"] - ms["add"], 0.0)
            per_clock = {op: (1 / (t * 1e-3 * sms * float(clock) * 1e6) if t > 0 else
                              float("inf")) for op, t in ms.items()}
            rates[type_name(comp)] = {"ms_per_op": ms, "per_clock_and_sm": per_clock}
            print(f"leaf floor: {type_name(comp)} operations, {n_ops} each on "
                  f"{OP_RATE_BLOCKS} x {OP_RATE_THREADS} threads (queued_ms), issue rate in "
                  f"operations a clock and SM at {clock} MHz on {sms} SMs: " + ", ".join(
                      f"{op} {per_clock[op]:.2f} ({ms[op] / ms['add']:.1f} adds)"
                      for op in leaf_eval.RATE_OPS)
                  + "; exp is x -> -exp(x), log1p x -> log1p(x) + 0.3, div x -> 1.5 / x, cvt "
                  f"a float32 -> {type_name(comp)} conversion beside an add, the add's time "
                  f"taken off  [{smi}]", flush=True)
        return {"clock_mhz": float(clock), "sms": sms, **rates}

    def leaf_ops(plan, in_dtype, out_dtype):
        """The operations that the leaf phase needs on one column, by class
        (basic: an add, multiply, compare or select; exp; log1p; div; cvt,
        a conversion to or from float64): each sample element widened once;
        per basis row the loop sums over its nonzero entries and |q|^2; with
        a G leaf eps and softplus(-beta eps) (an exp of -|beta eps| and a
        log1p); with a G counterterm also s and sbar, 1 / (1 + that exp)
        and the exp times it (a division), which the sign of tau does not
        change (softplus(x) = softplus(-x) + x); per leaf row its times and
        value by kind and order (a bare propagator or a G counterterm: one
        exp of its phase), and the rounding to storage.  csrc/leaf_eval.cu
        does more for a G counterterm, as its plain version does: softplus,
        s and sbar again per leaf row (four exps, a log1p, two divisions)."""
        from collections import Counter
        ops = Counter()
        c64 = plan.compute_dtype == torch.float64
        if c64 and in_dtype == torch.float32:
            ops["cvt"] += 3 * plan.n_loop + plan.n_tau
        rows, leaves = plan.rows.cpu().numpy(), plan.leaves.cpu().numpy()
        basis_rows = {}   # basis row -> (nonzero entries, the kinds of its leaves)
        for _, meta, begin, end in plan.segs.cpu().tolist():
            if meta & leaf_eval.SEG_HAS_BASIS:
                _, kinds = basis_rows.setdefault(int(rows[leaves[begin, 0], 2]),
                                                 (meta & leaf_eval.SEG_NZ_MASK, set()))
                kinds.update((leaves[begin:end, 1] & 0xFF).tolist())
        for nz, kinds in basis_rows.values():
            ops["basic"] += 3 * 2 * nz + 3 + 2
            if kinds & {leaf_eval.KIND_G0, leaf_eval.KIND_G_TOWER}:
                ops.update({"basic": 1 + 4, "exp": 1, "log1p": 1})
            if leaf_eval.KIND_G_TOWER in kinds:
                ops.update({"basic": 2, "div": 1})
        poly = plan.polys

        def tower(n):
            basic = 6 + 3 + 1 + 2 + 1 + 3 + 2 + sum(2 + 3 * m for m in range(n))
            for k in range(2, n + 1):
                basic += 2 + sum(int(poly[k, 1 + 3 * t]) - 1 + int(poly[k, 2 + 3 * t]) + 2
                                 for t in range(poly[k, 0]))
            return Counter({"basic": basic, "exp": 1})

        per_kind = {leaf_eval.KIND_ONE: lambda n: Counter(),
                    leaf_eval.KIND_G0: lambda n: Counter({"basic": 10, "exp": 1}),
                    leaf_eval.KIND_G_TOWER: tower,
                    leaf_eval.KIND_V_LAMBDA: lambda n: Counter({"basic": 3 + n, "div": 1}),
                    leaf_eval.KIND_V_TAYLOR: lambda n: Counter({"basic": 2 + n, "div": 1})}
        for kind, order, rows_k, _, _ in plan.groups:
            for cls, n in per_kind[kind](order).items():
                ops[cls] += n * len(rows_k)
        if c64 and out_dtype != torch.float64:
            ops["cvt"] += plan.num_leaves
        return ops

    def leaf_bounds(plan, batch, in_dtype, out_dtype):
        """The bound of the leaf phase at batch: the larger of bytes (the
        samples read once, the leaves written once, over the memory rate)
        and the operation floor (leaf_ops, each class at op_ms's measured
        time an operation of the compute type; basic at an add's)."""
        in_size = torch.empty((), dtype=in_dtype).element_size()
        out_size = torch.empty((), dtype=out_dtype).element_size()
        n_bytes = ((3 * plan.n_loop + plan.n_tau) * in_size + plan.num_leaves * out_size) * batch
        ops = leaf_ops(plan, in_dtype, out_dtype)
        per = op_ms[type_name(plan.compute_dtype)]["ms_per_op"]
        floor = sum(n * batch * per["add" if cls == "basic" else cls] for cls, n in ops.items())
        t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
        return {"ms": max(t_bytes, floor), "by": "bytes" if t_bytes >= floor else "operations",
                "bytes_ms": t_bytes, "floor_ms": floor, "bytes": n_bytes,
                "operations": {k: v * batch for k, v in ops.items()}}

    def leaf_times(label, c, n_loop, n_tau):
        """The leaf kernel, its plain version and the phase as c.leaf_fn
        runs it, back to back (queued_ms) at batch BATCH on float32
        samples, leaves in float32 (the main path's types), beside
        leaf_bounds.  Returns the numbers."""
        plan = c.leaf_fn.plan
        vk = torch.randn((3, n_loop, BATCH), generator=dev_gen, device=dev)
        vt = torch.rand((n_tau, BATCH), generator=dev_gen, device=dev) * BETA
        out = torch.empty((plan.num_leaves, BATCH), dtype=torch.float32, device=dev)
        t = {"leaf_eval": queued_ms(lambda: leaf_eval.leaf_eval(plan, vk, vt, out)),
             "plain": queued_ms(lambda: leaf_eval.leaf_eval_plain(plan, vk, vt, out)),
             "phase": queued_ms(lambda: c.leaf_fn(vk, vt, out=out))}
        b = leaf_bounds(plan, BATCH, torch.float32, torch.float32)
        print(f"leaf time: {label} batch {BATCH}, float32 samples and leaves, compute "
              f"{type_name(plan.compute_dtype)}, device ms back to back (queued_ms): leaf_eval "
              f"{t['leaf_eval']:.4f}, plain "
              f"{t['plain']:.4f}, the phase as make_leaf_evaluator runs it {t['phase']:.4f}; "
              f"byte bound {b['bytes_ms']:.4f} (samples read and leaves written once), "
              f"operation floor {b['floor_ms']:.4f} (" + ", ".join(
                  f"{k} {v:.3e}" for k, v in sorted(b["operations"].items()))
              + f"), by {b['by']}: the kernel at {b['ms'] / t['leaf_eval']:.3f} of the larger; "
              f"{plan.num_leaves} leaf rows, {plan.n_basis} basis rows, {plan.n_pairs} pairs "
              f"of times, {plan.n_items} items  [{smi}]", flush=True)
        del vk, vt, out
        return {"ms": t, "bounds": b}

    def once_each(n_leaf):
        """Whether each leaf kernel ran once a call by the profiler's counts,
        read rounded up: a trace may lose a kernel (PERF.md, section 6), a
        second launch shows as more than one."""
        return all(math.ceil(x - 1e-9) == 1 for x in n_leaf)

    def leaf_phase_kernels(label, c, n_loop, n_tau):
        """By the profiler's names: one call of c.leaf_fn on float32
        samples launches the leaf kernel once and nothing else."""
        vk = torch.randn((3, n_loop, BATCH), generator=dev_gen, device=dev)
        vt = torch.rand((n_tau, BATCH), generator=dev_gen, device=dev) * BETA
        out = torch.empty((c.tables.num_leaves, BATCH), dtype=torch.float32, device=dev)
        by_kernel, _, n_leaf, _, _ = profile_calls(lambda: c.leaf_fn(vk, vt, out=out))
        others = [k for k in by_kernel if not any(n in k for n in LEAF_KERNELS)]
        print(f"leaf kernel: {label}, one leaf phase by the profiler's names: "
              f"{n_leaf[0]:.1f} leaf_eval kernels a call, other device work: "
              f"{others or 'none'}", flush=True)
        if not once_each(n_leaf) or others:
            fail(f"leaf kernel: {label}: the leaf phase ran {n_leaf} leaf kernels and {others} "
                 f"besides, expected the kernel once and nothing else")

    leaf_report = {"checks": {}, "times": {}}
    c = compiled["fused"]
    leaf_report["checks"]["gamma4 order 4"] = check_leaf_kernels(
        "order-4 Gamma4", c.tables, para.totalLoopNum, para.totalTauNum)
    leaf_report["checks"]["gamma4 order 4, items of 3"] = check_leaf_kernels(
        "order-4 Gamma4, basis rows split", c.tables, para.totalLoopNum, para.totalTauNum,
        item_leaves=3)
    # G of orders 0 and 1, V of orders 0-2 (basis row 2 V-only), two rows of no group
    v_only = leaf_eval.LeafTables(
        leaf_type=np.array([1, 0, 2, 1, 3, 2, 2], np.int32),
        g_order=np.array([0, 0, 0, 1, 0, 0, 0], np.int32),
        v_order=np.array([0, 0, 0, 0, 0, 2, 1], np.int32),
        tau_in=np.array([1, 1, 1, 2, 1, 1, 1], np.int32),
        tau_out=np.array([2, 1, 1, 1, 1, 1, 1], np.int32),
        loop_idx=np.array([0, 0, 1, 1, 0, 2, 2], np.int32),
        loop_basis=np.array([[1.0, 0.0], [1.0, -1.0], [0.0, 1.0]]))
    leaf_report["checks"]["V-only rows and rows of no group"] = check_leaf_kernels(
        "a table of V-only basis rows and rows of no group", v_only, 2, 2)
    op_ms = op_rates()
    leaf_report["times"]["gamma4 order 4"] = leaf_times("order-4 Gamma4 fused", c,
                                                        para.totalLoopNum, para.totalTauNum)
    leaf_phase_kernels("order-4 Gamma4 fused", c, para.totalLoopNum, para.totalTauNum)
    phase("leaf kernels")

    # -- 4a. scale-out: NCCL with one rank, the graph-sharded pass on a local mesh
    import tempfile
    import torch.distributed as dist
    from feynmandiagram_tpu_torch.backends.compile import leaf_graphs_of
    from feynmandiagram_tpu_torch.benchmarks import certify_sharded
    from feynmandiagram_tpu_torch.examples import config5_serving
    from feynmandiagram_tpu_torch.ops.leaf_eval import leaf_tables_from_lowered
    from feynmandiagram_tpu_torch.parallel import (Mesh, lower_sharded_best,
                                                   make_graph_sharded_evaluator, make_mc_step,
                                                   make_sample_mesh, rank_seed, shard_compiled)
    from feynmandiagram_tpu_torch.utils import initialize_distributed

    c = compiled["fused"]
    num_tau_tab = int(max(c.tables.tau_in.max(), c.tables.tau_out.max()))
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            mesh1 = make_sample_mesh(device=dev)
            got = shard_compiled(c, mesh1)(varK, varT)
            want = c(varK, varT)
            means = make_mc_step(c, mesh1, beta=BETA)(SEED, BATCH)
            ref = mc_run(c.fn, n_loop=c.max_loop_num, num_tau=num_tau_tab, batch=BATCH,
                         n_roots=len(c.lowered.root_slots), device=dev, dtype=torch.float32,
                         iters=1, beta=BETA, seed=rank_seed(SEED, 0)) / BATCH
            torch.cuda.synchronize()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    print(f"scale-out: {backend} with one rank ({mesh1.shape}): shard_compiled of the fused "
          f"slice at batch {BATCH} vs the unsharded evaluator bit for bit: "
          f"{torch.equal(got, want)}; make_mc_step vs mc_run on the same generator bit for "
          f"bit: {torch.equal(means, ref)}", flush=True)
    if backend != "nccl" or not (torch.equal(got, want) and torch.equal(means, ref)):
        fail(f"scale-out: {backend} one-rank mesh differs from the unsharded path")
    del got, want

    mesh_g = Mesh([("graph", N_GRAPH)], device=dev)
    leafmap = leafmap_of(roots)
    sharded_runs, shard_keep = {}, {}
    for mode in ("fused", "bucketed"):
        t0 = time.perf_counter()
        low_s, sched = lower_sharded_best(roots, leafmap, N_GRAPH, sum_mode=mode)
        tables_s = leaf_tables_from_lowered(low_s, leaf_graphs_of(roots), para.totalLoopNum)
        sh = make_graph_sharded_evaluator(low_s, mesh_g, dtype=torch.float32)
        built = time.perf_counter() - t0
        st = sh.stats
        sizes = (st.full_slots, st.local_slots, st.halo_bytes_per_sample(),
                 round(st.halo_pad_overhead, 3), round(st.early_share, 3))
        n_lvl = sum(1 for lv in sh.device_eval.levels if lv[0].tables is not None)
        want_sizes, want_lvl = SHARD_PLAN[mode]
        print(f"scale-out: {mode} order-4 Gamma4 on a local {N_GRAPH}-rank graph mesh "
              f"(schedule {sched}, planned in {built:.1f} s): full slots {sizes[0]}, slots a "
              f"rank {sizes[1]}, halo {sizes[2]} B/sample f32, pad {sizes[3]}, early "
              f"{sizes[4]}, {n_lvl} level launches a rank (the JAX planner: {want_sizes}, "
              f"{want_lvl})", flush=True)
        if sizes != want_sizes or n_lvl != want_lvl or n_lvl != sum(
                1 for lvl in low_s.levels if level_buckets(lvl)):
            fail(f"scale-out {mode}: plan {sizes}, {n_lvl} launches a rank, not the JAX "
                 f"planner's {want_sizes}, {want_lvl}")
        single = make_evaluator(low_s, device=dev, dtype=torch.float32)
        leaf32 = make_leaf_evaluator(tables_s, beta=BETA, kF=KF, lam=LAM, device=dev,
                                     dtype=torch.float32)
        leaf64 = make_leaf_evaluator(tables_s, beta=BETA, kF=KF, lam=LAM, device=dev,
                                     dtype=torch.float64)
        plain64 = make_evaluator(low_s, device=dev, dtype=torch.float64, kernel=False)
        for batch in ((BATCH, RAGGED_BATCH) if mode == "fused" else (BATCH,)):
            vk = gen.standard_normal((3, para.totalLoopNum, batch))
            vt = gen.random((para.totalTauNum, batch)) * BETA
            leaves = leaf32(vk, vt)
            want = single(leaves)
            torch.cuda.synchronize()
            kernel_fn.launches = 0
            zero_levels()
            got = sh(leaves)
            torch.cuda.synchronize()
            n_launch = levels_run()
            ref = plain64(leaf64(vk, vt))
            d = (got.double() - ref).abs()
            rel = (d.max(dim=1).values / ref.abs().max(dim=1).values).max().item()
            print(f"scale-out: {mode} sharded pass, batch {batch} f32: {n_launch} level launches "
                  f"({n_launch // N_GRAPH} a rank), {kernel_fn.launches} bucket launches; vs the "
                  f"unsharded evaluator on the same lowering bit for bit: "
                  f"{torch.equal(got, want)}; vs the f64 plain path worst per-root "
                  f"{rel:.3e} (limit {SLICE_TOL:g})", flush=True)
            if n_launch != N_GRAPH * want_lvl or kernel_fn.launches != 0:
                fail(f"scale-out {mode}, batch {batch}: {n_launch} level and "
                     f"{kernel_fn.launches} bucket launches, expected {N_GRAPH * want_lvl}, 0")
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"scale-out {mode}, batch {batch}: the sharded roots differ from the "
                     f"unsharded evaluator's: max|diff| {(got - want).abs().max().item():.3e}")
            if not rel <= SLICE_TOL:
                fail(f"scale-out {mode}, batch {batch}: {rel:.3e} from the f64 plain path")
            sharded_runs[mode, batch] = (sh, leaves, single, n_launch)
        if mode == "fused":
            fused_low, fused_tables = low_s, tables_s
        shard_keep[mode] = low_s    # for the jit sharded phase
        del leaf64, plain64

    # the kernel against its plain version through src, every level of rank
    # 0, for the four dtype pairs; Kahan bit for bit, plain sums within the
    # bound of check_levels
    sh, leaves, _, _ = sharded_runs["fused", BATCH]
    src_err, out_scale = {}, 0.0
    for batch in (BATCH, RAGGED_BATCH):
        ev = sh.device_eval
        blocks = sh.blocks(sharded_runs["fused", batch][1])
        ws = ev.init(blocks)
        for w, blk in zip(ws, blocks):
            # init leaves the rows that later levels write as torch.empty
            # gave them; this check compares whole buffers, from zeros there
            w[blk.shape[0]:] = 0
        for li, halo in ev.halos(ws):
            t32 = ev.levels[li][0].tables
            if t32 is None:
                ev.compute(li, ws, halo)
                continue
            bl = [(i.cpu().numpy(), f.cpu().numpy(), st_) for i, f, st_ in
                  kernels.unpack_level(t32)]
            for storage, acc in ((torch.float32, None), (torch.float64, None),
                                 (torch.float32, torch.float64), (torch.bfloat16, torch.float32)):
                fac_dtype = acc or storage
                t = kernels.pack_level(bl, dev, fac_dtype)
                w0, h = ws[0].to(storage), halo.to(storage)
                wm = w0.abs().double()
                level_plain(wm, kernels.pack_level([(i, np.abs(f), st_) for i, f, st_ in bl],
                                                   dev, torch.float64), src=h.abs().double())
                for comp in (False, True):
                    wk, wp = w0.clone(), w0.clone()
                    level_fn(wk, t, src=h, compensated=comp, acc_dtype=acc)
                    level_plain(wp, t, src=h, compensated=comp, acc_dtype=acc)
                    diff = (wk.double() - wp.double()).abs()
                    bound = RTOL[type_name(fac_dtype)] * wm
                    if acc not in (None, storage):
                        bound = bound + STORE_ULP[type_name(storage)] * wm
                    ok = not bool(diff.any()) if comp else not bool((diff > bound).any())
                    if not torch.isfinite(wk).all() or not ok:
                        fail(f"scale-out: level {li} of rank 0 through src, "
                             f"{type_name(storage)}/{type_name(fac_dtype)} batch {batch} "
                             f"compensated={comp}: max|diff| {diff.max().item():.3e}")
                    key = (type_name(storage), type_name(fac_dtype), comp)
                    src_err[key] = max(src_err.get(key, 0.0), diff.max().item())
                    out_scale = max(out_scale, wp.abs().max().item())
            ev.compute(li, ws, halo)
        del ws
    print("scale-out: level kernel = plain through src=halo on every level of rank 0, batches "
          f"{BATCH} and {RAGGED_BATCH}, the pass's own values (outputs up to "
          f"{out_scale:.3e}), max|diff| (Kahan must be 0): " + ", ".join(
              f"{s_}/{a_}{' Kahan' if k_ else ''} {e:.3e}" for (s_, a_, k_), e in
              src_err.items()), flush=True)

    def serve_check(low_s, tables_s, label):
        """The graph-sharded MC step of examples/config5_serving.py on a
        local 4 x 2 mesh at BATCH a device, SHARD_MC_ITERS iterations, on
        low_s: its level launches (one a level that holds buckets or plans, a rank,
        a batch rank and an iteration) and its means against the unsharded
        evaluator on the same draws, bit for bit or within SHARD_MC_TOL.
        Returns the step's planner stats and whether the means were bit for
        bit."""
        kernel_fn.launches = 0
        zero_levels()
        sh_means, sh_step, sh_mesh = config5_serving.serve(
            low_s, tables_s, device=dev, batch_per_device=BATCH, iters=SHARD_MC_ITERS,
            seed=SEED)
        torch.cuda.synchronize()
        mc_launch = levels_run()
        n_batch = sh_mesh.shape["batch"]
        single_s = make_evaluator(low_s, device=dev, dtype=torch.float32)
        leaf_s = make_leaf_evaluator(tables_s, beta=BETA, kF=KF, lam=LAM, device=dev,
                                     dtype=torch.float32)
        n_loop = tables_s.loop_basis.shape[1]
        n_tau = int(max(tables_s.tau_in.max(), tables_s.tau_out.max()))
        per_rank, mc_dtype = [], sh_means.dtype
        for b in range(n_batch):
            acc = torch.zeros(len(low_s.root_slots), dtype=mc_dtype, device=dev)
            for i in range(SHARD_MC_ITERS):
                g_ = torch.Generator(device=dev)
                g_.manual_seed(rank_seed(SEED, b, i))
                vk = torch.randn((3, n_loop, BATCH), generator=g_, dtype=mc_dtype, device=dev)
                vt = torch.rand((n_tau, BATCH), generator=g_, dtype=mc_dtype, device=dev) * BETA
                acc = acc + single_s(leaf_s(vk, vt)).sum(dim=1)
            per_rank.append(acc / (SHARD_MC_ITERS * BATCH))
        mc_ref = per_rank[0]
        for m in per_rank[1:]:
            mc_ref = mc_ref + m
        mc_ref = mc_ref / n_batch
        mc_bitwise = torch.equal(sh_means, mc_ref)
        mc_rel = ((sh_means.double() - mc_ref.double()).abs().max()
                  / mc_ref.double().abs().max()).item()
        n_lvl = sum(1 for lvl in low_s.levels if level_buckets(lvl))
        want_launch = n_batch * SHARD_MC_ITERS * sh_mesh.shape["graph"] * n_lvl
        held = ("bit for bit" if mc_bitwise
                else f"scale-relative {mc_rel:.3e} (limit {SHARD_MC_TOL:g}), not bit for bit")
        print(f"{label}: graph-sharded MC step on a local {sh_mesh.shape} mesh, batch {BATCH} "
              f"a device, {SHARD_MC_ITERS} iterations: {mc_launch} level launches (expected "
              f"{want_launch}); means vs the unsharded evaluator on the same draws: {held}",
              flush=True)
        if mc_launch != want_launch or not (mc_bitwise or mc_rel <= SHARD_MC_TOL):
            fail(f"{label} MC step: {mc_launch} launches, means {mc_rel:.3e} from the reference")
        return sh_step.stats, mc_bitwise

    _, mc_bitwise = serve_check(fused_low, fused_tables, "scale-out")

    # benchmarks/certify_sharded.py on the same roots
    try:
        cert = certify_sharded.certify(4, N_GRAPH, BATCH, dev, roots=roots)
    except RuntimeError as err:
        fail(f"scale-out: certify_sharded: {err}")
    print(f"scale-out: certify_sharded {json.dumps(cert)}", flush=True)

    # times of the sharded fused pass at batch 4096, beside the unsharded one
    sh, leaves, single, n_launch = sharded_runs["fused", BATCH]
    ev = sh.device_eval
    ws, halos = ev.init(sh.blocks(leaves)), []
    for li, halo in ev.halos(ws):
        halos.append(halo)
        ev.compute(li, ws, halo)
    launch_fns = [lambda w=w, t=lv.tables, h=halos[li]: level_fn(w, t, src=h)
                  for li, per_rank_lv in enumerate(ev.levels)
                  for w, lv in zip(ws, per_rank_lv) if lv.tables is not None]
    sends = ([ev.early[0]] + [x for li in range(len(ev.levels))
                              for x in [ev.late[li]] + ev.early[li + 1:li + 2]]
             + [ev.root_send])
    sh_busy, sh_wall = busy_ms(lambda: sh(leaves)), wall_ms(lambda: sh(leaves))
    sh_levels = queued_ms(lambda: [fn() for fn in launch_fns])
    sh_plain = sum(queued_ms(lambda li=li: [level_plain(w, lv.tables, src=halos[li])
                                            for w, lv in zip(ws, ev.levels[li])])
                   for li in range(len(ev.levels)))
    sh_halo = queued_ms(lambda: [ev.gather(ws, s_) for s_ in sends])
    # bound of the level launches: each launch's distinct rows read (from the
    # halo) and rows written, once each, over the memory rate, against its
    # operations over the float32 rate
    sh_tabs = [lv.tables for per_rank_lv in ev.levels for lv in per_rank_lv
               if lv.tables is not None]
    t_bytes = sum(t.rows_touched for t in sh_tabs) * BATCH * 4 / HBM_BYTES_PER_S
    t_ops = sum(int((t.desc[:, 1] * t.desc[:, 2] * (t.desc[:, 3] + 1)).sum())
                for t in sh_tabs) * BATCH / PEAK_FLOPS["float32"]
    sh_bound = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    un_busy, un_wall = busy_ms(lambda: single(leaves)), wall_ms(lambda: single(leaves))
    sharded_report = {"launches_per_pass": n_launch, "ms": sh_levels, "plain_ms": sh_plain,
                      "bound_ms": sh_bound[0], "bound_by": sh_bound[1],
                      "max_abs_err": src_err["float32", "float32", False],
                      "max_abs_err_kahan": src_err["float32", "float32", True],
                      "levels_per_rank": SHARD_PLAN["fused"][1], "ranks": N_GRAPH,
                      "busy_ms": sh_busy, "wall_ms": sh_wall, "halo_ms": sh_halo,
                      "unsharded_busy_ms": un_busy, "unsharded_wall_ms": un_wall,
                      "batch": BATCH, "mc_bit_for_bit": mc_bitwise}
    print(f"scale-out time: fused sharded pass, {N_GRAPH} local ranks, batch {BATCH} f32: device "
          f"busy {sh_busy:.4f} ms, wall {sh_wall:.4f} ms a pass; its {len(launch_fns)} level "
          f"launches back to back {sh_levels:.4f} ms ({sh_bound[0] / sh_levels:.3f} of the "
          f"bound {sh_bound[0]:.4f} ms; plain, level by level, {sh_plain:.4f} ms); its "
          f"{len(sends)} halo gathers back to back {sh_halo:.4f} ms; the unsharded "
          f"pass on the same lowering: busy {un_busy:.4f} ms, wall {un_wall:.4f} ms  [{smi}]",
          flush=True)
    del sharded_runs, sh, ev, ws, halos, launch_fns, leaves, single
    torch.cuda.empty_cache()

    phase("scale-out")

    # -- 4b. the Hubbard atom: the port's graph phase against the closed form
    from feynmandiagram_tpu_torch.models import hubbard_atom as ha
    series = ha.sigma_power_series(HUBBARD_BETA)
    hubbard = {}

    def against_series(order, mean, err):
        """sigma_mc's (mean, stderr) at order against the closed-form
        series: order 1 exactly -U/2 (within ORDER1_REL), orders 2-5 within
        5 stderr (floored at HUBBARD_FLOOR).  The series' value, whether it
        held, and the distance in stderr."""
        expect = complex(series[order - 1] * HUBBARD_U ** order)
        if order == 1:
            half = HUBBARD_U / 2
            ok = abs(mean.real + half) <= ORDER1_REL * half and abs(mean.imag) <= ORDER1_REL
            return expect, ok, "n/a (no free tau)"
        bars = (5 * max(abs(err.real), HUBBARD_FLOOR[order]),
                5 * max(abs(err.imag), HUBBARD_FLOOR[order]))
        ok = abs(mean.real - expect.real) < bars[0] and abs(mean.imag - expect.imag) < bars[1]
        return expect, ok, (f"Re {(mean.real - expect.real) / err.real:+.2f}, "
                            f"Im {(mean.imag - expect.imag) / err.imag:+.2f}")
    for order in HUBBARD_ORDERS:
        t0 = time.perf_counter()
        hs = ha.build_sigma_evaluator(order, HUBBARD_BETA, device=dev, dtype=torch.float32)
        plain_hs = ha.build_sigma_evaluator(order, HUBBARD_BETA, device=dev,
                                            dtype=torch.float64, kernel=False)
        built = time.perf_counter() - t0
        hub_varT = torch.as_tensor(gen.random((hs.num_tau, HUBBARD_BATCH)) * HUBBARD_BETA,
                                   device=dev)
        hub_varT[0] = 0.0
        hub_ref = plain_hs.fn(hub_varT, HUBBARD_U)
        torch.cuda.synchronize()
        kernel_fn.launches = 0
        zero_levels()
        hub_got = hs.fn(hub_varT, HUBBARD_U)
        torch.cuda.synchronize()
        n_launch = levels_run()
        if n_launch != HUBBARD_BUCKET_LEVELS[order] or kernel_fn.launches != 0:
            fail(f"Hubbard order {order}: {n_launch} level and {kernel_fn.launches} bucket "
                 f"launches in a pass, expected {HUBBARD_BUCKET_LEVELS[order]} (one per level "
                 f"that holds buckets or plans) and 0")
        if (hub_got.shape != (2, HUBBARD_BATCH) or hub_got.dtype != torch.float32
                or not torch.isfinite(hub_got).all()):
            fail(f"Hubbard order {order}: output {hub_got.dtype} {tuple(hub_got.shape)} or not "
                 f"finite")
        # per channel max|d| / max|ref|; a channel that is 0 throughout must stay 0
        scale = hub_ref.abs().max(dim=1).values.clamp_min(torch.finfo(torch.float64).tiny)
        rel = ((hub_got.double() - hub_ref).abs().max(dim=1).values / scale).tolist()
        if not max(rel) <= SLICE_TOL:
            fail(f"Hubbard order {order}: f32 kernel vs f64 plain, max|d|/max|ref| Re "
                 f"{rel[0]:.3e} Im {rel[1]:.3e} > {SLICE_TOL}")
        mean, err = ha.sigma_mc(order, HUBBARD_U, HUBBARD_BETA, batch=HUBBARD_BATCH,
                                chunks=HUBBARD_CHUNKS, seed=order, device=dev,
                                dtype=torch.float32)
        expect, ok, z = against_series(order, mean, err)
        print(f"hubbard: order {order}, beta {HUBBARD_BETA}, U {HUBBARD_U}, f32: {n_launch} level "
              f"launches a pass (expected {HUBBARD_BUCKET_LEVELS[order]}); kernel vs f64 plain, "
              f"batch {HUBBARD_BATCH}, max|d|/max|ref| Re {rel[0]:.3e} Im {rel[1]:.3e} (limit "
              f"{SLICE_TOL:g}); sigma_mc {HUBBARD_BATCH} x {HUBBARD_CHUNKS}, seed {order}: mean "
              f"{mean:.6f}, stderr {err:.6f}, series {expect:.6f}, (mean - series)/stderr {z}; "
              f"built in {built:.2f} s", flush=True)
        if not ok:
            fail(f"Hubbard order {order}: sigma_mc {mean} (stderr {err}) against the series "
                 f"{expect}")

        def one_pass():
            hs.fn(hub_varT, HUBBARD_U)

        by_kernel, _, _, busy, _ = profile_calls(one_pass)
        level_busy = sum(t for k, t in by_kernel.items() if "gather_reduce_kernel" in k)
        wall = wall_ms(one_pass)
        hubbard[order] = {"launches_per_pass": n_launch, "max_rel_err": max(rel),
                          "busy_ms": busy, "wall_ms": wall}
        print(f"hubbard time: order {order}, batch {HUBBARD_BATCH} f32, one pass: device busy "
              f"{busy:.4f} ms, wall {wall:.4f} ms, {HUBBARD_BATCH / wall * 1e3:.0f} samples/s, "
              f"level launches {level_busy:.4f} ms ({level_busy / busy:.3f} of busy)  [{smi}]",
              flush=True)
        del hs, plain_hs, hub_varT, hub_ref, hub_got
        torch.cuda.empty_cache()

    phase("Hubbard atom")

    # -- 4c. config 4: the self-energy's counterterm series through the kernel
    from feynmandiagram_tpu_torch.benchmarks.bench_config4 import config4_roots
    t0 = time.perf_counter()
    roots4, para4, orders4 = config4_roots()
    print(f"host: config 4 (order-4 sigma, taylorAD([2, 2])) generated, differentiated and "
          f"optimized in {time.perf_counter() - t0:.1f} s ({len(roots4)} roots)", flush=True)
    config4, c4 = {}, {}
    for mode in ("fused", "bucketed"):
        t0 = time.perf_counter()
        c4[mode] = compile_evaluator(roots4, max_loop_num=para4.totalLoopNum, beta=BETA, kF=KF,
                                     lam=LAM, device=dev, dtype=torch.float32, sum_mode=mode)
        low4 = c4[mode].lowered
        n_plans = {k: sum(len(getattr(lvl, k)) for lvl in low4.levels)
                   for k in ("fused", "sum_buckets", "prods", "pows")}
        print(f"host: config 4 {mode} lowering in {time.perf_counter() - t0:.1f} s: "
              f"{low4.num_slots} slots, {low4.num_edges} edges, {len(low4.levels)} levels; "
              f"{n_plans['fused']} FusedBuckets, {n_plans['sum_buckets']} SumBuckets, "
              f"{n_plans['prods']} ProdPlans, {n_plans['pows']} PowerPlans", flush=True)
    del roots4
    leaf_report["checks"]["config 4"] = check_leaf_kernels(
        "config 4", c4["fused"].tables, para4.totalLoopNum, para4.totalTauNum)
    leaf_report["times"]["config 4"] = leaf_times("config 4 fused", c4["fused"],
                                                  para4.totalLoopNum, para4.totalTauNum)
    phase("config 4: host")
    # fused at the batches of the checks and of the timed passes below, the
    # bucketed lowering at one small batch only, to keep the run short
    for mode, batches in (("fused", (BATCH, RAGGED_BATCH, 2 * BATCH)),
                          ("bucketed", (CHECK_BATCH,))):
        low4 = c4[mode].lowered
        samples = [(gen.standard_normal((3, para4.totalLoopNum, batch)),
                    gen.random((para4.totalTauNum, batch)) * BETA) for batch in batches]
        n_levels, errs = check_slice(c4[mode], samples, f"config 4 {mode}", orders4)
        for batch, (rel, _) in errs.items():
            k = int(np.argmax(rel))
            print(f"config4: {mode} f32 kernel vs f64 plain on the card, batch {batch}: "
                  f"{n_levels} level launches a pass ({n_levels} levels of {len(low4.levels)} "
                  f"hold buckets or plans; {len(orders4)} roots); worst per-root max|d|/max|ref| "
                  f"{rel[k]:.3e} at root {k}, (g_order, v_order) {orders4[k]} (limit "
                  f"{SLICE_TOL:g})", flush=True)
        config4[mode] = {"launches_per_pass": n_levels,
                         "max_rel_err": max(max(rel) for rel, _ in errs.values())}
    phase("config 4: checks")
    fused4, batch = c4.pop("fused"), 2 * BATCH
    del c4
    config4["fused"].update({f"mc_{b}": m for b, m in mc_lines(
        fused4, para4, (batch, 2 * batch), "config4 mc: fused").items()})
    # where a pass's host time goes: the leaf phase and the graph phase
    # alone, each on the clocks of the mc lines
    vk = torch.randn((3, para4.totalLoopNum, batch), generator=dev_gen, device=dev)
    vt = torch.rand((para4.totalTauNum, batch), generator=dev_gen, device=dev) * BETA
    leaves4 = fused4.leaf_fn(vk, vt)
    tab = fused4.tables
    n_groups = len(set(zip(tab.leaf_type.tolist(), tab.g_order.tolist(), tab.v_order.tolist())))
    split = {name: (wall_ms(fn, n=20), busy_ms(fn)) for name, fn in (
        ("leaf phase", lambda: fused4.leaf_fn(vk, vt)),
        ("graph phase", lambda: fused4.graph_fn(leaves4)))}
    config4["fused"]["split_ms"] = {name: {"wall_ms": a, "busy_ms": b}
                                    for name, (a, b) in split.items()}
    low4 = fused4.lowered
    tabs4 = tables_of(low4, torch.float32)
    n_pows = sum(len(lvl.pows) for lvl in low4.levels)
    print(f"config4 split: fused batch {batch} f32, one call alone, wall / device busy: "
          + "; ".join(f"{name} {a:.4f} / {b:.4f} ms" for name, (a, b) in split.items())
          + f" ({len(tabs4)} level launches and {n_pows} PowerPlans in the graph phase, "
          f"{n_groups} (leaf type, order) groups in the leaf phase)  [{smi}]", flush=True)
    w = rand_w(low4.num_slots, batch, torch.float32)
    ld, per_level, bounds = level_pass_ms(low4, w, tabs4)
    plain = sum(queued_ms(lambda t=t: level_plain(w, t)) for t in tabs4)
    bound = sum(b["ms"] for b in bounds)
    config4["fused"].update({"ms": ld, "plain_ms": plain, "bound_ms": bound,
                             "bound_by": max(bounds, key=lambda b: b["ms"])["by"],
                             "library_ms": None, "batch": batch})
    print(f"config4 time: fused batch {batch} f32, the buckets of a pass, device, back to "
          f"back: {len(tabs4)} level launches {ld:.4f} ms ({bound / ld:.3f} of the bound "
          f"{bound:.4f} ms); plain, level by level, {plain:.4f} ms  [{smi}]", flush=True)
    levels_line(f"config4 levels: fused batch {batch} f32", per_level, bounds)
    jit_keep["config 4 fused"] = (fused4, para4)    # for the jit phase
    del fused4, w, tabs4, leaves4, vk, vt
    torch.cuda.empty_cache()

    phase("config 4: times")

    # -- 4d. the exact-diagonalization oracle on the card, in float64
    from feynmandiagram_tpu_torch.models import atom_ed
    from feynmandiagram_tpu_torch.models.free_fermion import green_kernel
    ed_beta, ed_mu = 2.0, 0.4
    taus = torch.rand(ED_TAUS, generator=dev_gen, dtype=torch.float64, device=dev)
    taus = (2 * taus - 1) * ed_beta
    free = atom_ed.hubbard_atom_model(0.0, ed_mu, ed_beta)
    g_ed = free.g_tau(taus, device=dev)
    g_free = green_kernel(taus, torch.tensor(-ed_mu, dtype=torch.float64, device=dev), ed_beta)
    if g_ed.dtype != torch.float64 or g_ed.device.type != "cuda":
        fail(f"atom_ed.g_tau: {g_ed.dtype} on {g_ed.device}, expected float64 on the card")
    free_err = ((g_ed - g_free).abs() / g_free.abs()).max().item()
    cpu_err = ((g_ed.cpu() - free.g_tau(taus.cpu(), device="cpu")).abs()
               / g_ed.cpu().abs()).max().item()
    print(f"ed: U=0 atom (beta {ed_beta}, mu {ed_mu}), g_tau on the card in float64 at "
          f"{ED_TAUS} taus in (-beta, beta) vs the free kernel: max rel {free_err:.3e} (limit "
          f"{ED_RTOL:g}); vs the same on the CPU: max rel {cpu_err:.3e} (limit {ED_RTOL:g})",
          flush=True)
    if not (free_err <= ED_RTOL and cpu_err <= ED_RTOL):
        fail("atom_ed.g_tau on the card: off the free kernel or off the CPU")
    sig_err = 0.0
    for u, mu, beta in ED_SIGMA_CASES:
        ghat = atom_ed.hubbard_atom_model(u, mu, beta).g_matsubara(4, device=dev)
        for n in range(4):
            wn = (2 * n + 1) * math.pi / beta
            sig = 1j * wn + mu - 1.0 / (-ghat[n])
            want = -ha.exact_sigma(wn, u, beta, mu)
            err = abs(sig - want)
            sig_err = max(sig_err, err / abs(want))
            if not err <= 1e-10 + 1e-8 * abs(want):
                fail(f"ED sigma at U {u}, mu {mu}, beta {beta}, n {n}: {sig} against the closed "
                     f"form {want}")
    print(f"ed: the ED self-energy iw + mu - 1/G against -exact_sigma at (U, mu, beta) "
          f"{ED_SIGMA_CASES}, n 0-3: max rel {sig_err:.3e} (limit 1e-8 + 1e-10 absolute)",
          flush=True)
    u, mu, beta = ED_HOP
    g_at = atom_ed.hubbard_atom_model(u, mu, beta).g_matsubara(2, device=dev)
    hop = []
    for t in (0.02, 0.04):
        g01 = atom_ed.hubbard_dimer_model(t, u, mu, beta).g_matsubara(2, 0, 1, device=dev)
        for n in range(2):
            hop.append(abs(g01[n] - t * g_at[n] ** 2) / t ** 3)
    wick = max(abs(m.g2_connected(0.8, 0.35, 0.6, 0.1, *modes, device=dev))
               for m in (atom_ed.hubbard_atom_model(0.0, 0.3, 1.2),
                         atom_ed.hubbard_dimer_model(0.7, 0.0, 0.1, 0.9))
               for modes in ((0, 0, 0, 0), (0, 1, 1, 0)))
    print(f"ed: dimer (U, mu, beta) {ED_HOP}, t 0.02 and 0.04, n 0-1: |G01 - t g_atom^2| / t^3 "
          f"max {max(hop):.4f} (limit 0.05); U=0 connected 4-point, atom and dimer, max "
          f"{wick:.3e} (limit 1e-10)", flush=True)
    if not (max(hop) < 0.05 and wick < 1e-10):
        fail("ED dimer: first-order hopping identity or Wick's theorem at U=0 broken")
    def ed_one():
        free.g_tau(taus, device=dev)

    ed_busy, ed_wall = busy_ms(ed_one), wall_ms(ed_one)
    print(f"ed time: g_tau of the atom at {ED_TAUS} taus, float64, one call: device busy "
          f"{ed_busy:.4f} ms, wall {ed_wall:.4f} ms  [{smi}]", flush=True)
    del taus, g_ed, g_free

    phase("ED oracle")

    # -- 5. throughput and per-pass times
    def sum_buckets_of(low):
        """The SumBuckets of low as buckets (n_op 1), level by level: the
        launches' part that one sparse product each computes."""
        return [(np.asarray(sb.idx)[None], np.asarray(sb.fac), sb.start)
                for lvl in low.levels for sb in lvl.sum_buckets]

    def sparse_buckets(low):
        """Each SumBucket of low as the [count, num_slots] CSR matrix whose
        product with w is the bucket's function."""
        mats = []
        for idx, fac, _ in sum_buckets_of(low):
            _, arity, count = idx.shape
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
        ld, per_level, bounds = level_pass_ms(c.lowered, w, tabs)
        kb, pb = in_turns(wall_ms, all_buckets(kernel_fn), all_buckets(plain_fn))
        lb = wall_ms(level_pass())
        bound = sum(b["ms"] for b in bounds)
        times[mode] = {"level_ms": ld, "bucket_ms": kd, "plain_ms": pd, "bound_ms": bound,
                       "bound_by": max(bounds, key=lambda b: b["ms"])["by"]}
        if mode == "fused":
            launch_sizes(c.lowered, w, bl)
        plain_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float32, kernel=False)
        leaves = c.leaf_fn(varK, varT)
        kg, pg = in_turns(wall_ms, lambda: c.graph_fn(leaves), lambda: plain_graph(leaves))
        gq = queued_ms(lambda: c.graph_fn(leaves))
        times[mode]["graph_wall_ms"] = kg
        print(f"time: {mode} batch {BATCH} f32, the buckets of a pass, device, back to back: "
              f"{len(tabs)} level launches {ld:.4f} ms ({bound / ld:.3f} of the bound "
              f"{bound:.4f} ms = distinct rows per level + written rows over 3.35 TB/s; rows "
              f"counted per bucket {sum(b['per_bucket_ms'] for b in bounds):.4f} ms); the same "
              f"kernel bucket by bucket, {len(bl)} launches, {kd:.4f} ms; plain {pd:.4f} ms.  "
              f"Wall: level launches {lb:.4f} ms, bucket by bucket {kb:.4f} ms, plain "
              f"{pb:.4f} ms; graph phase wall kernel {kg:.4f} ms vs plain {pg:.4f} ms, queued "
              f"{gq:.4f} ms  [{smi}]", flush=True)
        levels_line(f"levels: {mode} batch {BATCH} f32", per_level, bounds)
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
            for (idx, fac, start), out in zip(sum_buckets_of(c.lowered), outs):
                wk = w.clone()
                kernel_fn(wk, torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=dev),
                          torch.as_tensor(np.ascontiguousarray(fac), device=dev).float(), start)
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
        times[mode]["mc"] = mc_lines(c, para, (BATCH, 2 * BATCH), f"mc: {mode}")

    phase("times and Monte-Carlo runs")

    # -- 5a. GV-table diagrams through the level kernel, the source export, the
    # profiler's phases
    import contextlib
    import subprocess
    from types import SimpleNamespace
    from feynmandiagram_tpu_torch import mc as mc_mod
    from feynmandiagram_tpu_torch.backends import compile_python, to_python_str
    from feynmandiagram_tpu_torch.computational_graph import eval_graph
    from feynmandiagram_tpu_torch.frontends import gv as gv_front
    from feynmandiagram_tpu_torch.ops import evaluator as evaluator_mod
    from feynmandiagram_tpu_torch.ops import leaf_eval as leaf_eval_mod
    from feynmandiagram_tpu_torch.taylor import set_variables
    from feynmandiagram_tpu_torch.utility import taylorexpansion_feynman

    def gv_read(kind, order):
        """GV diagrams of kind at order from the port's bundled tables,
        optimized at level 1, with their loop and tau counts read from the
        leaves; and the seconds it took."""
        t0 = time.perf_counter()
        rts = list(gv_front.diagsGV(kind, order))
        ids = [leaf.properties for leaf in leaf_graphs_of(rts).values()]
        optimize_inplace(rts, level=1)
        sizes = SimpleNamespace(totalLoopNum=max(len(i.extK) for i in ids),
                                totalTauNum=max(max(i.extT) for i in ids))
        return rts, sizes, time.perf_counter() - t0

    def gv_samples(sizes, batch):
        return (gen.standard_normal((3, sizes.totalLoopNum, batch)),
                gen.random((sizes.totalTauNum, batch)) * BETA)

    def plan_counts(low):
        """Slots, edges, levels and buckets (fused and sum) of low."""
        return (low.num_slots, low.num_edges, len(low.levels),
                sum(len(lvl.fused) + len(lvl.sum_buckets) for lvl in low.levels))

    def level_errs(low, label):
        """check_levels of low at BATCH in float32, Kahan off and on."""
        w = rand_w(low.num_slots, BATCH, torch.float32)
        return {comp: check_levels(low, w, torch.float32, None, comp,
                                   f"{label} batch {BATCH} compensated={comp}")
                for comp in (False, True)}

    # profile_pass of the fused order-4 Gamma4 pass in a fresh process, whose
    # profiler has not traced before; started now, so that its host work and
    # its traced passes run while this process reads the order-6 tables on
    # the host and launches nothing
    prof_cmd = ("import sys; sys.modules['jax'] = None; sys.modules['feynmandiagram_tpu'] = None; "
                "from feynmandiagram_tpu_torch.benchmarks.profile_pass import main; main()")
    torch.cuda.synchronize()
    prof_t0 = time.perf_counter()
    prof_proc = subprocess.Popen([sys.executable, "-c", prof_cmd, "4", str(BATCH), "20",
                                  "--levels"], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def profile_done():
        """Wait for profile_pass, print its table; its JSON line and the
        seconds it took."""
        try:
            out, err = prof_proc.communicate(timeout=600)
        finally:
            if prof_proc.poll() is None:
                prof_proc.kill()
                prof_proc.wait()
        if prof_proc.returncode != 0:
            fail(f"profile_pass exited {prof_proc.returncode}: {err[-3000:]}")
        out_lines = out.strip().splitlines()
        for line in out_lines[:-1]:
            if line.strip():
                print(f"gv profile_pass: {line}", flush=True)
        return json.loads(out_lines[-1])["profile_pass"], time.perf_counter() - prof_t0

    try:
        roots6, sizes6, read_s = gv_read("sigma", 6)
    except BaseException:
        prof_proc.kill()
        prof_proc.wait()
        raise
    prof, prof_s = profile_done()
    print(f"gv: sigma order 6 read from the port's bundled tables and optimized in "
          f"{read_s:.1f} s: {len(roots6)} roots; max_loop_num {sizes6.totalLoopNum} and "
          f"{sizes6.totalTauNum} taus, from the leaves", flush=True)
    gv6 = {}
    for mode in ("fused", "bucketed"):
        t0 = time.perf_counter()
        c6 = compile_evaluator(roots6, max_loop_num=sizes6.totalLoopNum, beta=BETA, kF=KF,
                               lam=LAM, device=dev, dtype=torch.float32, sum_mode=mode)
        built = time.perf_counter() - t0
        counts = plan_counts(c6.lowered)
        n_levels, errs = check_slice(c6, [gv_samples(sizes6, BATCH)], f"gv sigma 6 {mode}")
        if mode == "fused":
            leaf_report["checks"]["GV sigma 6"] = check_leaf_kernels(
                "GV sigma 6", c6.tables, sizes6.totalLoopNum, sizes6.totalTauNum)
            leaf_report["times"]["GV sigma 6"] = leaf_times(
                "GV sigma 6 fused", c6, sizes6.totalLoopNum, sizes6.totalTauNum)
        rel = errs[BATCH][0]
        print(f"gv: sigma 6 {mode}, lowered in {built:.1f} s: {counts[0]} slots, {counts[1]} "
              f"edges, {counts[2]} levels, {counts[3]} buckets (the CPU lowering's "
              f"{GV_SIGMA6[mode]}); f32 kernel vs f64 plain on the card, batch {BATCH}: "
              f"{n_levels} level launches a pass, worst per-root max|d|/max|ref| "
              f"{max(rel):.3e} (limit {SLICE_TOL:g})", flush=True)
        if counts != GV_SIGMA6[mode]:
            fail(f"gv sigma 6 {mode}: slots, edges, levels, buckets {counts}, not the CPU "
                 f"lowering's {GV_SIGMA6[mode]}")
        lerr = level_errs(c6.lowered, f"gv sigma 6 {mode}")
        print(f"gv: level launch = plain on every level of the sigma 6 {mode} lowering, f32, "
              f"batch {BATCH}: Kahan max|diff| {lerr[True]:.3e} (must be 0), plain sums "
              f"max|diff| {lerr[False]:.3e}", flush=True)
        w = rand_w(c6.lowered.num_slots, BATCH, torch.float32)
        tabs = tables_of(c6.lowered, torch.float32)
        ld, per_level, bounds = level_pass_ms(c6.lowered, w, tabs)
        plain = sum(queued_ms(lambda t=t: level_plain(w, t)) for t in tabs)
        bound = sum(b["ms"] for b in bounds)
        rep = {"launches_per_pass": n_levels, "max_rel_err": max(rel),
               "max_abs_err": lerr[False], "max_abs_err_kahan": lerr[True], "ms": ld,
               "plain_ms": plain, "bound_ms": bound,
               "bound_by": max(bounds, key=lambda b: b["ms"])["by"], "library_ms": None,
               "batch": BATCH, "slots": counts[0], "edges": counts[1], "levels": counts[2],
               "buckets": counts[3]}
        lib_line = ""
        if mode == "bucketed":
            mats = sparse_buckets(c6.lowered)
            for (idx, fac, start), mat in zip(sum_buckets_of(c6.lowered), mats):
                wk = w.clone()
                kernel_fn(wk, torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=dev),
                          torch.as_tensor(np.ascontiguousarray(fac), device=dev).float(), start)
                out = torch.sparse.mm(mat, w)
                d = (out - wk[start:start + out.shape[0]]).abs().max().item()
                if not d <= 1e-4 * out.abs().max().item():
                    fail(f"gv sigma 6: torch.sparse.mm differs from the kernel on the bucket at "
                         f"row {start}: max|diff| {d:.3e}")
                del wk, out
            rep["library_ms"] = sum(
                queued_ms(lambda k=k: [torch.sparse.mm(m, w) for m in mats[k:k + QUEUED_BUCKETS]])
                for k in range(0, len(mats), QUEUED_BUCKETS))
            lib_line = (f"; torch.sparse.mm of each of the {len(mats)} buckets' CSR matrices "
                        f"with w, back to back, {rep['library_ms']:.4f} ms")
            del mats
        print(f"gv time: sigma 6 {mode} batch {BATCH} f32, the buckets of a pass, device, back "
              f"to back: {len(tabs)} level launches {ld:.4f} ms ({bound / ld:.3f} of the bound "
              f"{bound:.4f} ms = distinct rows per level + written rows over 3.35 TB/s); "
              f"plain, level by level, {plain:.4f} ms{lib_line}  [{smi}]", flush=True)
        levels_line(f"gv levels: sigma 6 {mode} batch {BATCH} f32", per_level, bounds)
        del w, tabs
        if mode == "fused":
            rep.update({f"mc_{b}": m for b, m in mc_lines(
                c6, sizes6, (BATCH, 4 * BATCH), "gv mc: sigma 6 fused").items()})
        gv6[mode] = rep
        if mode == "fused":
            jit_keep["GV sigma 6 fused"] = (c6, sizes6)    # for the jit phase
        del c6
        torch.cuda.empty_cache()
    del roots6

    # charge polarization at order 5, fused: the same checks, no timing
    roots_p, sizes_p, read_s = gv_read("chargePolar", 5)
    c_p = compile_evaluator(roots_p, max_loop_num=sizes_p.totalLoopNum, beta=BETA, kF=KF,
                            lam=LAM, device=dev, dtype=torch.float32, sum_mode="fused")
    n_levels, errs = check_slice(c_p, [gv_samples(sizes_p, BATCH)], "gv chargePolar 5 fused")
    lerr = level_errs(c_p.lowered, "gv chargePolar 5 fused")
    print(f"gv: chargePolar 5 fused (read and optimized in {read_s:.1f} s; slots, edges, "
          f"levels, buckets {plan_counts(c_p.lowered)}, max_loop_num {sizes_p.totalLoopNum}): "
          f"f32 kernel vs f64 plain, batch {BATCH}: {n_levels} level launches a pass, worst "
          f"per-root {max(errs[BATCH][0]):.3e} (limit {SLICE_TOL:g}); level launch = plain on "
          f"every level: Kahan {lerr[True]:.3e} (must be 0), plain sums {lerr[False]:.3e}",
          flush=True)
    del c_p, roots_p

    # a counterterm file through the Feynman-graph reader, beside taylorAD's
    # coefficient of the same order (tests/test_gv.py): leaf == 1 on the card
    # against the host interpreter, and the level kernel's checks
    g300 = gv_front.diagsGV("sigma", 3, 0, 0)[0]
    ct = gv_front.diagsGV("sigma", 3, g_order=1, v_order=1)[0]
    set_variables("x y", orders=[3, 3])
    tvec, _ = taylorexpansion_feynman(g300, ([True, False], [False, True]))
    n_ct = min(2, len(ct))
    ct_vals = {}
    for label, gs in (("tabulated Sigma3_1_1", list(ct[:n_ct])),
                      ("taylorexpansion_feynman coefficient (1, 1)",
                       [tvec[i].coeffs[(1, 1)] for i in range(n_ct)])):
        low = lower(gs, leafmap_of(gs), sum_mode="fused", cse=True)
        nl = low.num_leaves - len(low.const_slots)
        n_lv = sum(1 for lvl in low.levels if level_buckets(lvl))
        kernel_fn.launches = 0
        zero_levels()
        ones = make_evaluator(low, device=dev, dtype=torch.float64)(np.ones((nl, BATCH)))
        torch.cuda.synchronize()
        if levels_run() != n_lv or kernel_fn.launches != 0:
            fail(f"gv counterterms, {label}: {levels_run()} level launches, expected {n_lv}")
        host = [eval_graph(g) for g in gs]
        vals = gen.uniform(0.5, 1.5, (nl, BATCH))
        got = make_evaluator(low, device=dev, dtype=torch.float32)(vals)
        ref = make_evaluator(low, device=dev, dtype=torch.float64, kernel=False)(vals)
        rel = ((got.double() - ref).abs().max(dim=1).values
               / ref.abs().max(dim=1).values).max().item()
        lerr = level_errs(low, f"gv counterterms {label}")
        print(f"gv: sigma 3 counterterms, {label}: {len(gs)} roots, {n_lv} level launches a "
              f"pass; leaf == 1 on the card in f64 {ones[:, 0].tolist()} vs the host "
              f"interpreter {host}; f32 kernel vs f64 plain on leaves in [0.5, 1.5), batch "
              f"{BATCH}: worst per-root {rel:.3e} (limit {SLICE_TOL:g}); level launch = plain: "
              f"Kahan {lerr[True]:.3e}, plain sums {lerr[False]:.3e}", flush=True)
        if not (torch.equal(ones, ones[:, :1].expand_as(ones)) and np.allclose(
                ones[:, 0].tolist(), host, rtol=1e-12, atol=0) and rel <= SLICE_TOL):
            fail(f"gv counterterms, {label}: off the host interpreter or the plain path")
        ct_vals[label] = host
    if not np.allclose(*ct_vals.values(), rtol=1e-12, atol=0):
        fail(f"gv counterterms: the tabulated file and taylorAD's coefficient differ: {ct_vals}")

    # the source export as a third evaluation: the optimized sigma-4 roots as
    # torch source, node by node, against the level launches, float64
    roots4g, sizes4g, _ = gv_read("sigma", 4)
    c4g = compile_evaluator(roots4g, max_loop_num=sizes4g.totalLoopNum, beta=BETA, kF=KF,
                            lam=LAM, device=dev, dtype=torch.float64, sum_mode="fused")
    src_fn, src_map = compile_python(roots4g)
    eval_map = leafmap_of(roots4g)
    rows = torch.as_tensor([eval_map[u] for u, _ in sorted(src_map.items(),
                                                         key=lambda kv: kv[1])], device=dev)
    leaves = c4g.leaf_fn(*gv_samples(sizes4g, BATCH))
    n_lv = sum(1 for lvl in c4g.lowered.levels if level_buckets(lvl))
    zero_levels()
    want = c4g.graph_fn(leaves)
    torch.cuda.synchronize()
    launched = levels_run()
    got = src_fn(leaves[rows])
    src_rel = ((got - want).abs().max(dim=1).values / want.abs().max(dim=1).values).max().item()
    n_nodes = len(to_python_str(roots4g)[0].splitlines()) - 5
    print(f"gv: source export of the optimized sigma 4 roots (compile_python, torch, {n_nodes} "
          f"assignments) on the card in {got.dtype}, batch {BATCH}, vs the evaluator's "
          f"{launched} level launches in float64 on the same leaves: worst per-root "
          f"max|d|/max|ref| {src_rel:.3e} (limit {EXPORT_RTOL:g})", flush=True)
    if (got.device.type != "cuda" or got.dtype != torch.float64 or launched != n_lv
            or not src_rel <= EXPORT_RTOL):
        fail(f"gv source export: {got.dtype} on {got.device}, {launched} launches, {src_rel:.3e}")
    del c4g, leaves, want, got, roots4g

    c = compiled["fused"]
    mc_kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=BATCH,
                 n_roots=len(c.lowered.root_slots), device=dev, dtype=torch.float32, beta=BETA)

    def one_pass():
        mc_run(c.fn, iters=1, seed=SEED, **mc_kw)

    pass_q = queued_ms(one_pass)
    # the launches of a pass: a level's own, or a column run's over a stretch
    plan_launches = sum(len(step.paths) if isinstance(step, kernels.LevelRun) else 1
                        for step in c.graph_fn._plans[BATCH])
    phases_ms = sum(v[0] for v in prof["phase_op"].values()) / 1e3
    graph_ms = prof["phase_op"].get("graph", [0.0])[0] / 1e3
    print(f"gv profile: profile_pass 4 {BATCH} 20 --levels in a fresh process ({prof_s:.1f} s, "
          f"beside the read of the order-6 tables): its "
          f"phases' device time {phases_ms:.4f} ms a pass ({phases_ms / pass_q:.3f} of "
          f"the pass's busy time {pass_q:.4f} ms by queued_ms here; limit {PROFILE_COVER}), "
          f"graph {graph_ms:.4f} ms, {prof['level_kernels_in_graph']:.1f} level kernels a pass "
          f"inside level scopes (expected {plan_launches}: the launch plan's), leaf kernels "
          f"a pass by name "
          f"{prof['leaf_kernels']}, "
          f"{prof['unattributed_ops']:.1f} device ops a pass without a launching call  [{smi}]",
          flush=True)
    if not once_each(tuple(prof["leaf_kernels"][k] for k in LEAF_KERNELS)):
        fail(f"profile_pass: leaf kernels a pass {prof['leaf_kernels']}, expected once")
    if not phases_ms >= PROFILE_COVER * pass_q:
        fail(f"profile_pass: phases hold {phases_ms:.4f} ms of a {pass_q:.4f} ms pass: the trace "
             f"lost kernels")
    if prof["level_kernels_in_graph"] != plan_launches:
        fail(f"profile_pass: {prof['level_kernels_in_graph']} level kernels a pass attributed to "
             f"level scopes, expected {plan_launches}")
    # what the scopes cost with no profiler running: the same pass with
    # scope() and with a bare null context in its place, in turns
    scope_fns = {m: m.scope for m in (mc_mod, evaluator_mod, leaf_eval_mod)}
    bare = contextlib.nullcontext()
    walls = {"scope()": [], "bare": []}
    for key in ("scope()", "bare", "bare", "scope()"):
        for m_, f_ in scope_fns.items():
            m_.scope = f_ if key == "scope()" else (lambda name: bare)
        walls[key].append(wall_ms(one_pass, n=50))
    for m_, f_ in scope_fns.items():
        m_.scope = f_
    walls = {k: float(np.mean(v)) for k, v in walls.items()}
    print(f"gv profile: fused order-4 Gamma4 MC pass, batch {BATCH} f32, no profiler running, "
          f"wall a pass: {walls['scope()']:.4f} ms with the scopes' code, {walls['bare']:.4f} ms "
          f"with scope() replaced by a bare null context (in turns); the mc: line's "
          f"{times['fused']['mc'][BATCH]['wall_ms']:.4f} ms and the time: line's graph phase "
          f"{times['fused']['graph_wall_ms']:.4f} ms; profile_pass untraced "
          f"{prof['wall_ms_per_pass']:.4f} ms, traced {prof['traced_wall_ms_per_pass']:.4f} ms"
          f"  [{smi}]", flush=True)
    gv_report = {"sigma6": gv6, "profile": {
        "phases_device_ms": phases_ms, "pass_busy_ms": pass_q, "graph_ms": graph_ms,
        "phase_op_us": prof["phase_op"], "phase_host_us": prof["phase_host"],
        "leaf_kernels": prof["leaf_kernels"], "wall_ms": walls}}
    phase("gv")

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
    zero_levels()
    got = c64(varK, varT)
    torch.cuda.synchronize()
    n_levels = sum(1 for lvl in c64.lowered.levels if level_buckets(lvl))
    if levels_run() != n_levels:
        fail(f"f64-acc slice: kernel launched {levels_run()} times, expected {n_levels}")
    if got.dtype != torch.float64 or got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"f64-acc slice: output {got.dtype} {tuple(got.shape)} or not finite")
    worst = per_root(got, ref)
    print(f"slice: fused f32 storage / f64 accumulation via compile_evaluator (built in "
          f"{time.perf_counter() - t0:.1f} s) vs f64 plain, batch {BATCH}: "
          f"{levels_run()} kernel launches per pass, worst per-root {worst:.3e} "
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
    zero_levels()
    mixed = make_evaluator(low2, device=dev, dtype=torch.bfloat16,
                           acc_dtype=torch.float32)(vals.astype(np.float32))
    torch.cuda.synchronize()
    denom = torch.maximum(f64.abs(), 1e-3 * f64.abs().max())
    rel = (mixed.double() - f64).abs() / denom
    med, top = rel.median().item(), rel.max().item()
    print(f"graph: order-2 bucketed bf16 storage / f32 accumulation vs f64, batch 16: "
          f"{levels_run()} kernel launches, median rel {med:.3e} (limit 1e-2), max "
          f"{top:.3e} (limit 0.5)", flush=True)
    if mixed.dtype != torch.float32 or levels_run() == 0 or not (med < 1e-2 and
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
                if got.shape != ref.shape or not bool((d <= ONEHOT_REL.get(name, 0.0)
                                                       * ref.abs()).all()):
                    fail(f"probe {name} on random data {S}x{B}, rows {r}: max|diff| "
                         f"{d.max().item():.3e}")
                err, n = max(err, d.max().item()), n + 1
        probe_err[name] = err
        print(f"probe: {name} kernel = plain on the JAX data and {n} random cases "
              f"({'within 2^-11 relative, TF32' if ONEHOT_REL.get(name) else 'exact'}), "
              f"max|diff| {err:.3e}", flush=True)
    out_of_range = (("dma8", (4089,)), ("dma8", (-1,)), ("dmagrp", (4096,)), ("dmagrp", (-1,)),
                    ("dma8_bulk", (4089,)), ("dmagrp_bulk", (4096,)), ("dmadyn_dst", (512,)))
    for name, r in out_of_range:
        try:
            getattr(pm, f"case_{name}")(w_p, rows_t(r))
        except ValueError:
            continue
        fail(f"probe {name}: an out-of-range source {r} did not raise")
    print("probe: out-of-range copy sources raise: "
          + ", ".join(f"{name} {r[0]}" for name, r in out_of_range), flush=True)
    # dmadyn_dst: every rows[1] mod 4 on both sides of 0, from the first, a
    # middle and the last group, at widths from one 16-byte piece to ones
    # its old 32-row scratch refused (B > 1812); take on blocks of 10 rows up
    n_dyn = n_take = 0
    grid = [(S, B) for S in (8, 1000, 4096) for B in (4, 100, 512, 4096, 16384)]
    for S, B in grid + [(64, 1816), (64, 32768)]:
        wr = rand_w(S, B, torch.float32)
        for r in sorted({0, S // 16, S // 8 - 1}):
            for r1 in range(-5, 5):
                got = pm.case_dmadyn_dst(wr, rows_t((r, r1)))
                ref = pm.case_dmadyn_dst_plain(wr, rows_t((r, r1)))
                if got.shape != ref.shape or not torch.equal(got, ref):
                    fail(f"probe dmadyn_dst on {S}x{B}, rows {(r, r1)}: not the plain version's "
                         f"rows")
                n_dyn += 1
    for S in (10, 100, 256, 300):
        for B in (4, 100, 512, 4096, 16384):
            wr = rand_w(S, B, torch.float32)
            got, ref = pm.case_take(wr, rows_t((0,))), pm.case_take_plain(wr, rows_t((0,)))
            if got.shape != ref.shape or not torch.equal(got, ref):
                fail(f"probe take on {S}x{B}: not the plain version's rows")
            n_take += 1
    print(f"probe: dmadyn_dst = plain, exact, on {n_dyn} cases (rows[1] -5..4 x the first, a "
          f"middle and the last group x S 8, 1000, 4096 x B 4 to 16384, and B 1816, 32768); take "
          f"= plain, exact, on {n_take} (S 10, 100, 256, 300 x B 4 to 16384)", flush=True)
    # dynwrite: every residue of r mod 8 (negative r and r past the block
    # among them), blocks of 1 to 300 rows whose row 0 holds -0.0, infinities
    # and a NaN, widths from one 16-byte piece up; bit for bit
    n_dynwrite = 0
    for S in (1, 8, 300):
        for B in (4, 100, 512, 4096, 16384):
            wr = torch.randn((S, B), generator=dev_gen, device=dev)
            wr[0, :4] = torch.tensor([-0.0, float("inf"), float("-inf"), float("nan")])
            for r in DYNWRITE_ROWS:
                got = pm.case_dynwrite(wr, rows_t((r,)))
                ref = pm.case_dynwrite_plain(wr, rows_t((r,)))
                if got.shape != ref.shape or not torch.equal(got.view(torch.int32),
                                                             ref.view(torch.int32)):
                    fail(f"probe dynwrite on {S}x{B}, r {r}: not the plain version's bits")
                n_dynwrite += 1
    print(f"probe: dynwrite = plain bit for bit on {n_dynwrite} cases: r {DYNWRITE_ROWS} "
          f"(every residue mod 8) x S 1, 8, 300 x B 4 to 16384, row 0 holding -0.0, +-inf and "
          f"NaN", flush=True)
    # acc: every edge of the clamp in each of its rows and in all four; both
    # designs of onehot: every residue mod 8 about 0, 8 and K - 8, and starts
    # that select nothing; blocks of fewer than 256 rows, widths from one
    # 16-byte piece up
    onehot_designs = (pm.case_onehot, pm.case_onehot_mma)   # of record, variant
    onehot_rel = {fn: ONEHOT_REL[fn.__name__[len("case_"):]] for fn in onehot_designs}
    onehot_err = {fn: 0.0 for fn in onehot_designs}
    n_acc = n_onehot = 0
    for S in (8, 100, 256, 300):
        k = min(pm.BLOCK_ROWS, S)
        edges = (k - 1, k, -1, -k, -k - 1, 2 ** 31 - 1, -2 ** 31)   # the clamp's, size 1
        base = (k // 3, k - 1, 0, k // 2)
        acc_rows = ([base[:p] + (e,) + base[p + 1:] for p in range(4) for e in edges]
                    + [(e,) * 4 for e in edges])
        onehot_starts = sorted({a + d for a in (0, 8, k - 8) for d in range(-8, 8)}
                               | {-8, k, 2 ** 31 - 1})
        for B in (4, 100, 512, 4096, 16384):
            wr = torch.randn((S, B), generator=dev_gen, device=dev)
            for r in acc_rows:
                got, ref = pm.case_acc(wr, rows_t(r)), pm.case_acc_plain(wr, rows_t(r))
                if got.shape != ref.shape or not torch.equal(got.view(torch.int32),
                                                             ref.view(torch.int32)):
                    fail(f"probe acc on {S}x{B}, rows {r}: not the plain version's bits")
                n_acc += 1
            for r in onehot_starts:
                ref = pm.case_onehot_plain(wr, rows_t((r,)))
                for fn in onehot_designs:
                    got = fn(wr, rows_t((r,)))
                    d = (got - ref).abs()
                    if got.shape != ref.shape or not bool((d <= onehot_rel[fn]
                                                           * ref.abs()).all()):
                        fail(f"probe {fn.__name__} on {S}x{B}, start {r}: max|diff| "
                             f"{d.max().item():.3e} (limit {onehot_rel[fn]:g} relative)")
                    onehot_err[fn] = max(onehot_err[fn], d.max().item())
                n_onehot += 1
    print(f"probe: acc = plain bit for bit on {n_acc} cases (each clamp edge in each row and in "
          f"all four) x S 8, 100, 256, 300 x B 4 to 16384; onehot on {n_onehot} starts (every "
          f"residue mod 8 about 0, 8 and K - 8; -8, K, 2^31 - 1) of the same grid: "
          + ", ".join(f"{fn.__name__} max|diff| {e:.3e} (limit {onehot_rel[fn]:g} relative)"
                      for fn, e in onehot_err.items()), flush=True)
    # the two slice kernels and their TMA variants: every edge of the clamp,
    # blocks of fewer than 256 rows, widths from one 16-byte piece up
    slices = ((1, pm.case_vmemrow, pm.case_vmemrow_bulk, pm.case_vmemrow_plain),
              (8, pm.case_vmem8, pm.case_vmem8_bulk, pm.case_vmem8_plain))
    n_edge, chunk_bytes = 0, pm.BULK_CHUNK_BYTES
    for S in (8, 100, 256, 300):
        k = min(pm.BLOCK_ROWS, S)
        for B in (4, 100, 512, 4096, 16384):
            wr = rand_w(S, B, torch.float32)
            for size, case, bulk, plain in slices:
                for r in (k - size, k - size + 1, k, -1, -k, -k - 1, 2 ** 31 - 1, -2 ** 31):
                    ref = plain(wr, rows_t((r,)))
                    for fn in (case, bulk):
                        got = fn(wr, rows_t((r,)))
                        if got.shape != ref.shape or not torch.equal(got, ref):
                            fail(f"probe {fn.__name__} on {S}x{B}, start {r}: not the plain "
                                 f"version's rows")
                    n_edge += 1
    for chunk in BULK_CHUNKS:   # a last chunk shorter than the others, and one chunk for all
        pm.BULK_CHUNK_BYTES = chunk
        for B in (100, 4096):
            wr = rand_w(300, B, torch.float32)
            for _, _, bulk, plain in slices:
                if not torch.equal(bulk(wr, rows_t((77,))), plain(wr, rows_t((77,)))):
                    fail(f"probe {bulk.__name__}, chunks of {chunk} bytes, B {B}: not the plain "
                         f"version's rows")
    pm.BULK_CHUNK_BYTES = chunk_bytes
    print(f"probe: vmemrow, vmem8 and their TMA variants = plain, exact, on {n_edge} cases: the "
          f"clamp's edges x S 8, 100, 256, 300 x B 4 to 16384; the TMA variants also in chunks "
          f"of {BULK_CHUNKS} bytes", flush=True)
    # the two copies and their TMA variants: no clamp, a 64-bit start
    copies = ((pm.case_dma8, pm.case_dma8_bulk, pm.case_dma8_plain),
              (pm.case_dmagrp, pm.case_dmagrp_bulk, pm.case_dmagrp_plain))

    def check_copies(wr):
        """dma8 from the first, the last and an unaligned middle start and
        dmagrp from every residue of a middle and of the last group, kernel
        and TMA variant against plain; returns the number of starts."""
        S = wr.shape[0]
        starts = (sorted({0, S - 8, min(S // 3 | 1, S - 8)}),
                  sorted({8 * g + k for g in (S // 16, S // 8 - 1) for k in range(8)}))
        for (case, bulk, plain), rs in zip(copies, starts):
            for r in rs:
                ref = plain(wr, rows_t((r,)))
                for fn in (case, bulk):
                    got = fn(wr, rows_t((r,)))
                    if got.shape != ref.shape or not torch.equal(got, ref):
                        fail(f"probe {fn.__name__} on {S}x{wr.shape[1]}, start {r}: not the "
                             f"plain version's rows")
        return len(starts[0]) + len(starts[1])

    n_copy = sum(check_copies(rand_w(S, B, torch.float32))
                 for S in (8, 1000, 4096) for B in (4, 100, 512, 4096, 16384))
    for chunk in BULK_CHUNKS:
        pm.BULK_CHUNK_BYTES = chunk
        for B in (100, 4096):
            check_copies(rand_w(1000, B, torch.float32))
    pm.BULK_CHUNK_BYTES = chunk_bytes
    wr = rand_w(*BIG_COPY, torch.float32)
    n_big = check_copies(wr)
    big_gb = wr.numel() * 4 / 1e9
    del wr
    torch.cuda.empty_cache()
    print(f"probe: dma8, dmagrp and their TMA variants = plain, exact, on {n_copy} starts: first, "
          f"last and an unaligned middle row, every residue mod 8 of a middle and of the last "
          f"group x S 8, 1000, 4096 x B 4 to 16384; the TMA variants also in chunks of "
          f"{BULK_CHUNKS} bytes; and on {n_big} starts of a {BIG_COPY[0]} x {BIG_COPY[1]} buffer "
          f"({big_gb:.1f} GB), the last rows {(BIG_COPY[0] - 8) * BIG_COPY[1] * 4} bytes in",
          flush=True)

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
    # the one PyTorch call that computes each probe's function
    r_p = [int(r) for r in rows_p.tolist()]
    library_calls = probe_library_calls(w_p, rows_p)

    def per_call_ms(fns, rounds=8):
        """median_ms of each of fns (events around one call on an idle
        stream, so mostly the host's launch work), taken in turns there and
        back, ``rounds`` times; the median of each one's readings."""
        seen = [[] for _ in fns]
        for _ in range(rounds):
            for k in [*range(len(fns)), *reversed(range(len(fns)))]:
                seen[k].append(median_ms(fns[k]))
        return [float(np.median(t)) for t in seen]

    # kernel, plain and library call on one clock, twice over: device time
    # (the profiler's busy time per call) and per-call time
    probe_dev, probe_call = {}, {}
    for _, case, plain in pm.CASES:
        name = case.__name__[len("case_"):]
        call = library_calls[name]
        if not torch.equal(call(), case(w_p, rows_p)):
            fail(f"probe {name}: its library call gives another result than the kernel")
        fns = [lambda: case(w_p, rows_p), lambda: plain(w_p, rows_p), call]
        probe_dev[name] = [busy_ms(fn, n=20) for fn in fns]
        probe_call[name] = per_call_ms(fns)

    def us(t):
        return f"{1e3 * t:.2f}"

    print("probe device time per call, kernel / plain / library call, us: " + ", ".join(
        f"{name} {' / '.join(map(us, probe_dev[name]))}" for name in PROBE_LINE)
        + f"  [{smi}]", flush=True)
    # the four copy kernels beside the design they were chosen over: a TMA
    # bulk load and bulk store through shared memory, a chunk a block
    variants = []
    for name in ("dma8", "dmagrp", "vmemrow", "vmem8"):
        case, bulk = getattr(pm, f"case_{name}"), getattr(pm, f"case_{name}_bulk")
        bulk_us = []
        for chunk in BULK_CHUNKS:
            pm.BULK_CHUNK_BYTES = chunk
            bulk_us.append(f"{chunk} B {us(busy_ms(lambda: bulk(w_p, rows_p), n=20))}")
        # and 20 calls back to back behind a sleep kernel, their gaps included
        plain = getattr(pm, f"case_{name}_plain")
        queued = [queued_ms(fn, n=20) for fn in (lambda: case(w_p, rows_p),
                                                 lambda: plain(w_p, rows_p),
                                                 library_calls[name])]
        variants.append(f"{name} load+store per thread {us(probe_dev[name][0])}, "
                        f"{us(busy_ms(lambda: case(w_p, rows_p), n=20))}; TMA load + store in "
                        f"chunks of " + ", ".join(bulk_us) + "; back to back kernel / plain / "
                        f"library call {' / '.join(map(us, queued))}")
    pm.BULK_CHUNK_BYTES = chunk_bytes
    # acc and onehot's two designs (in turns there and back, twice: the
    # median of four readings each), and 20 calls back to back
    acc_q = [queued_ms(fn, n=20) for fn in (lambda: pm.case_acc(w_p, rows_p),
                                            lambda: pm.case_acc_plain(w_p, rows_p),
                                            library_calls["acc"])]
    variants.append(f"acc gather-sum {us(probe_dev['acc'][0])}, "
                    f"{us(busy_ms(lambda: pm.case_acc(w_p, rows_p), n=20))}; back to back "
                    f"kernel / plain / library call {' / '.join(map(us, acc_q))}")
    seen = {fn: [] for fn in onehot_designs}
    for fn in [*onehot_designs, *reversed(onehot_designs)] * 2:
        seen[fn].append(busy_ms(lambda fn=fn: fn(w_p, rows_p), n=20))
    onehot_dev = {fn: float(np.median(v)) for fn, v in seen.items()}
    onehot_q = [queued_ms(lambda fn=fn: fn(w_p, rows_p), n=20) for fn in onehot_designs]
    onehot_q += [queued_ms(fn, n=20) for fn in (lambda: pm.case_onehot_plain(w_p, rows_p),
                                                library_calls["onehot"])]
    variants.append("onehot " + ", ".join(
        f"{fn.__name__} {us(t)} ({', '.join(map(us, seen[fn]))})" for fn, t in onehot_dev.items())
        + f"; back to back {' / '.join(fn.__name__ for fn in onehot_designs)} / plain / library "
        f"call {' / '.join(map(us, onehot_q))}")
    # dmadyn_dst beside dma8, the copy body it now shares (in turns there and
    # back, twice), and dmadyn_dst and take 20 back to back.  take's plain
    # version copies its row list from the host, which waits for the device,
    # so it cannot be queued: its back-to-back reading is left out
    pair = (pm.case_dmadyn_dst, pm.case_dma8)
    seen = {fn: [] for fn in pair}
    for fn in [*pair, *reversed(pair)] * 2:
        seen[fn].append(busy_ms(lambda fn=fn: fn(w_p, rows_p), n=20))
    variants.append("dmadyn_dst beside dma8 " + ", ".join(
        f"{fn.__name__} {us(float(np.median(v)))} ({', '.join(map(us, v))})"
        for fn, v in seen.items()))
    dyn_q = [queued_ms(fn, n=20) for fn in (lambda: pm.case_dmadyn_dst(w_p, rows_p),
                                            lambda: pm.case_dmadyn_dst_plain(w_p, rows_p),
                                            library_calls["dmadyn_dst"])]
    take_q = [queued_ms(fn, n=20) for fn in (lambda: pm.case_take(w_p, rows_p),
                                             library_calls["take"])]
    variants.append(f"dmadyn_dst back to back kernel / plain / library call "
                    f"{' / '.join(map(us, dyn_q))}; take back to back kernel / library call "
                    f"{' / '.join(map(us, take_q))}")
    # dynwrite beside dma8 (in turns there and back, twice), and 20 back to
    # back
    pair = (pm.case_dynwrite, pm.case_dma8)
    seen = {fn: [] for fn in pair}
    for fn in [*pair, *reversed(pair)] * 2:
        seen[fn].append(busy_ms(lambda fn=fn: fn(w_p, rows_p), n=20))
    dw_q = [queued_ms(fn, n=20) for fn in (lambda: pm.case_dynwrite(w_p, rows_p),
                                           lambda: pm.case_dynwrite_plain(w_p, rows_p),
                                           library_calls["dynwrite"])]
    variants.append("dynwrite beside dma8 " + ", ".join(
        f"{fn.__name__} {us(float(np.median(v)))} ({', '.join(map(us, v))})"
        for fn, v in seen.items())
        + f"; back to back kernel / plain / library call {' / '.join(map(us, dw_q))}")
    print("probe variants, device us per call: " + "; ".join(variants) + f"  [{smi}]",
          flush=True)
    # the two copies at other block sizes, through the library's own entry
    # (no wrapper: the device clock does not see the host), in turns there
    # and back
    lib = build.load("row_probes", pm._bind)
    stream = torch.cuda.current_stream().cuda_stream
    out8 = torch.empty((8, w_p.shape[1]), dtype=torch.float32, device=dev)

    def raw(entry, *args):
        """A call of the library's fd_probe_<entry> that fails the run on an error."""
        fn = getattr(lib, f"fd_probe_{entry}")

        def call():
            if fn(*args) != 0:
                fail(f"fd_probe_{entry}{args} did not launch")
        return call

    sweep = {}
    for group, name in enumerate(("dma8", "dmagrp")):
        fns = {t: raw("copy8_threads", w_p.data_ptr(), out8.data_ptr(), r_p[0], group, t,
                      w_p.shape[1], stream) for t in COPY_THREADS}
        for t, fn in fns.items():
            out8.zero_()
            fn()
            if not torch.equal(out8, getattr(pm, f"case_{name}_plain")(w_p, rows_p)):
                fail(f"probe {name} at {t} threads a block: not the plain version's rows")
        seen = {t: [] for t in COPY_THREADS}
        for t in [*COPY_THREADS, *reversed(COPY_THREADS)]:
            seen[t].append((busy_ms(fns[t], n=100), queued_ms(fns[t], n=20)))
        sweep[name] = {t: tuple(float(np.mean(x)) for x in zip(*v)) for t, v in seen.items()}
    print("probe block sizes, device us per call alone / 20 back to back: " + "; ".join(
        f"{name} " + ", ".join(f"{t} threads {us(a)} / {us(q)}" for t, (a, q) in by.items())
        for name, by in sweep.items()) + f"  [{smi}]", flush=True)
    # a launch's floor: an empty kernel through the same launch path, on the
    # device clock alone and back to back, and on the per-call clock
    floors = {}
    for grid, threads in EMPTY_GRIDS:
        fn = raw("empty", grid, threads, stream)
        floors[grid, threads] = (busy_ms(fn, n=100), queued_ms(fn, n=20), median_ms(fn))
    floor_dev = min(f[0] for f in floors.values())
    print("launch floor, an empty kernel, us: " + "; ".join(
        f"<<<{g}, {t}>>> device {us(a)}, 20 back to back {us(q)}, per call (no wrapper) {us(c)}"
        for (g, t), (a, q, c) in floors.items()) + f"  [{smi}]", flush=True)
    print(f"probe device time over the floor of {us(floor_dev)} us: " + ", ".join(
        f"{name} {probe_dev[name][0] / floor_dev:.2f}" for name in PROBE_LINE)
        + "; plain " + ", ".join(f"{name} {probe_dev[name][1] / floor_dev:.2f}"
                                 for name in PROBE_LINE) + f"  [{smi}]", flush=True)
    # bound: the rows a probe must read and write, once each, over the memory
    # rate; for onehot also its 2 * 8 * 256 * B operations over the TF32 rate.
    # dmadyn_dst reads its 8 rows only where rows[1] mod 4 == 0
    row_bytes = w_p.shape[1] * 4
    probe_rows = {"dma8": 16, "dmagrp": 16, "vmemrow": 2, "vmem8": 16, "acc": 5, "onehot": 16,
                  "dynwrite": 9, "dmadyn_dst": 16 if r_p[1] % 4 == 0 else 8, "take": 16}
    probe_bound = {}
    for name, n_rows in probe_rows.items():
        t_bytes = n_rows * row_bytes / HBM_BYTES_PER_S
        t_ops = (2 * 8 * pm.BLOCK_ROWS * w_p.shape[1] / PEAK_FLOPS["tf32"]
                 if name == "onehot" else n_rows * w_p.shape[1] / PEAK_FLOPS["float32"])
        probe_bound[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                             else "operations")
    print("probe per-call time (events around one call, the host's launch work included), "
          "kernel / plain / library call, us, and bound: " + ", ".join(
              f"{name} {' / '.join(map(us, probe_call[name]))}, "
              f"{1e6 * probe_bound[name][0]:.1f} ns ({probe_bound[name][1]})"
              for name in PROBE_LINE)
          + f"; a launch's floor ({us(floor_dev)} us on the device), not the bound, is what "
          f"the probes meet"
          + f"  [{smi}]", flush=True)

    phase("probes")

    # -- 9. gather strategies and the streaming roofline
    kernel_fn.launches = 0
    gather = probe_gather.run()
    if not gather["bucket_ok"] or kernel_fn.launches < 1:
        fail(f"probe_gather: bucket kernel check {gather['bucket_ok']}, "
             f"{kernel_fn.launches} launches")

    phase("gather probe")

    # -- 10. Gamma4 at orders 3, 5 and 6, the JAX package's other orders
    import dataclasses
    from feynmandiagram_tpu_torch.backends.compile import (CompiledEvaluator, eager_pass,
                                                           load_artifact)
    from feynmandiagram_tpu_torch.benchmarks import gamma4_orders as g4
    from feynmandiagram_tpu_torch.benchmarks import probe_split, probe_structure, scaling
    from feynmandiagram_tpu_torch.benchmarks import scan_merge

    def g4_counts(low):
        """Slots, edges, levels, buckets and ProdPlans of low; its roots
        and leaves."""
        return ((low.num_slots, low.num_edges, len(low.levels),
                 sum(len(lvl.fused) + len(lvl.sum_buckets) for lvl in low.levels),
                 sum(len(lvl.prods) for lvl in low.levels)),
                (len(low.root_slots), low.num_leaves))

    def wait_child(order):
        """Wait for the host child of order, print its lines; the paths of
        its artifacts.  A child that failed fails the run."""
        proc, log, started = g4_children[order]
        try:
            rc = proc.wait(timeout=max(CHILD_TIMEOUT - (time.perf_counter() - started), 1))
        except subprocess.TimeoutExpired:
            fail(f"gamma4: the order-{order} host child ran past {CHILD_TIMEOUT} s")
        log.flush()
        with open(log.name) as f:
            lines = f.read().splitlines()
        for line in lines[:-1]:
            print(f"gamma4 host: {line}", flush=True)
        if rc != 0 or not lines:
            fail(f"gamma4: the order-{order} host child exited {rc}: {lines[-20:]}")
        done = json.loads(lines[-1])
        print(f"gamma4 host: order {order} artifacts {sorted(done['paths'])} written in "
              f"{done['seconds']} s by the child; waited for here "
              f"{time.perf_counter() - started:.1f} s after its start", flush=True)
        return done["paths"]

    def from_artifact(path):
        """load_artifact -> make_leaf_evaluator + make_evaluator on the card,
        float32: the route of orders that take minutes on the host."""
        low, tabs = load_artifact(path)
        leaf_fn = make_leaf_evaluator(tabs, beta=BETA, kF=KF, lam=LAM, device=dev,
                                      dtype=torch.float32)
        graph_fn = make_evaluator(low, device=dev, dtype=torch.float32)
        return CompiledEvaluator(low, tabs, eager_pass(leaf_fn, graph_fn), leaf_fn, graph_fn,
                                 tabs.loop_basis.shape[1])

    def g4_diagnose(c, vk, vt, k, ref):
        """Root k's error under Kahan sums and under float64 accumulation,
        on the same float32 leaves; and with the graph phase in float64 on
        those leaves, the leaf phase's part."""
        leaves = c.leaf_fn(vk, vt)
        errs = {}
        for name, dtype, kw in (("compensated=True", torch.float32, {"compensated": True}),
                                ("acc_dtype=torch.float64", torch.float32,
                                 {"acc_dtype": torch.float64}),
                                ("a float64 graph phase", torch.float64, {"kernel": False})):
            got = make_evaluator(c.lowered, device=dev, dtype=dtype, **kw)(leaves)[k]
            errs[name] = ((got.double() - ref[k]).abs().max() / ref[k].abs().max()).item()
        print(f"gamma4: root {k} misses SLICE_TOL; its max|d|/max|ref| on the same float32 "
              f"leaves " + ", ".join(f"under {name} {e:.3e}" for name, e in errs.items())
              + f" (max|ref| {ref[k].abs().max().item():.4e}, median|ref| "
              f"{ref[k].abs().median().item():.4e})", flush=True)
        return errs

    def leaf_control(label, c, vk, vt):
        """The control of the leaf phase's float64 arithmetic: the same
        float32 pass on leaves computed in float32 arithmetic, as the JAX
        package computes them, against the float64 plain path; and those
        leaves' relative error against the float64 leaves rounded once
        (c's)."""
        kw = dict(beta=BETA, kF=KF, lam=LAM, device=dev)
        leaves = c.leaf_fn(vk, vt)
        leaves32 = make_leaf_evaluator(c.tables, dtype=torch.float32,
                                       compute_dtype=torch.float32, **kw)(vk, vt)
        ref = make_evaluator(c.lowered, device=dev, dtype=torch.float64, kernel=False)(
            make_leaf_evaluator(c.tables, dtype=torch.float64, **kw)(vk, vt))
        got = c.graph_fn(leaves32)
        rel = (got.double() - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
        k = int(rel.argmax())
        normal = leaves.abs() >= torch.finfo(torch.float32).tiny   # not flushed to 0 or subnormal
        d = (leaves32.double() - leaves.double())[normal].abs() / leaves.double()[normal].abs()
        sub = d[::-(-d.numel() // 2 ** 23)]
        q = torch.quantile(sub, torch.tensor([0.5, 0.99], dtype=d.dtype, device=dev)).tolist()
        found = {"max_rel_err": rel[k].item(), "root": k, "leaf_rel_err_median": q[0],
                 "leaf_rel_err_p99": q[1], "leaf_rel_err_max": d.max().item()}
        print(f"gamma4: {label}, control: the leaves computed in float32 arithmetic (as the "
              f"JAX package computes them), not float64 rounded once, put root {k} at "
              f"{rel[k].item():.3e} (limit {SLICE_TOL:g}); those leaves against the rounded "
              f"ones, where these are normal ({d.numel()} of {leaves.numel()}): relative error "
              f"median {q[0]:.3e}, 99th percentile {q[1]:.3e}, max "
              f"{found['leaf_rel_err_max']:.3e}", flush=True)
        del leaves, leaves32, ref, got, d, sub, normal
        return found

    def library_ms(low, w, tabs):
        """torch.sparse.mm of each SumBucket's CSR matrix with w, each held
        to the level launch's rows, then timed back to back."""
        mats, k = sparse_buckets(low), 0
        for lvl, tab in zip([lv for lv in low.levels if level_buckets(lv)], tabs):
            wk = w.clone()
            level_fn(wk, tab)
            for sb in lvl.sum_buckets:
                start = sb.start
                out = torch.sparse.mm(mats[k], w)
                d = (out - wk[start:start + out.shape[0]]).abs().max().item()
                if not d <= 1e-4 * out.abs().max().item():
                    fail(f"gamma4: torch.sparse.mm differs from the level launch on the bucket "
                         f"at row {start}: max|diff| {d:.3e}")
                k += 1
            del wk
        return sum(queued_ms(lambda k=k: [torch.sparse.mm(m, w)
                                          for m in mats[k:k + QUEUED_BUCKETS]])
                   for k in range(0, len(mats), QUEUED_BUCKETS))

    def busy_split(label, c, para_o, w, levels_ms, busy):
        """Where the device time of a pass at BATCH goes: the leaf phase,
        the eager pass's buffer (torch.empty and the rows it zeroes:
        Evaluator.buffer, since the leaf phase writes straight into it), the
        level launches (measured already, the ProdPlans and PowerPlans of
        arity or exponent 1..4 among them) and the plain ProdPlans and
        PowerPlans (those above 4: none in these lowerings), each by
        queued_ms."""
        vk = torch.randn((3, para_o.totalLoopNum, BATCH), generator=dev_gen, device=dev)
        vt = torch.rand((para_o.totalTauNum, BATCH), generator=dev_gen, device=dev) * BETA
        leaf_ms = queued_ms(lambda: c.leaf_fn(vk, vt))
        buffer_ms = queued_ms(lambda: c.graph_fn.buffer(BATCH))
        zeroed = c.graph_fn.eager_zero_rows
        plain_lv = [dataclasses.replace(lv, csr=None, tables=None)
                    for lv in evaluator_mod._upload(c.lowered, dev, torch.float32)]
        prod_ms = queued_ms(lambda: evaluator_mod._eval_levels(plain_lv, w))
        parts = {"leaf_ms": leaf_ms, "buffer_ms": buffer_ms, "levels_ms": levels_ms,
                 "prods_ms": prod_ms}
        print(f"gamma4 busy: {label} batch {BATCH} f32, device ms by queued_ms: leaf phase "
              f"{leaf_ms:.4f}, the eager buffer ({w.numel() * 4 / 1e9:.2f} GB, "
              f"{0 if zeroed is None else zeroed.numel()} rows zeroed) {buffer_ms:.4f}, "
              f"level launches {levels_ms:.4f}, plain ProdPlans and PowerPlans {prod_ms:.4f}; sum "
              f"{sum(parts.values()):.4f} against the pass's busy {busy:.4f} (profiler)  "
              f"[{smi}]", flush=True)
        return parts

    def g4_lowering(order, mode, c):
        """The checks and times of one lowering: counts, the f32 pass
        against the f64 plain path, every level against its plain version,
        the level launches beside their bound (bucketed: and beside
        torch.sparse.mm), the Monte-Carlo lines and, from order 5 on, where
        a pass's device time goes."""
        label = f"order {order} {mode}"
        low = c.lowered
        counts = g4_counts(low)
        para_o = g4.vertex4_para(order)
        batch = GAMMA4_CHECK_BATCH[order]
        vk = gen.standard_normal((3, para_o.totalLoopNum, batch))
        vt = gen.random((para_o.totalTauNum, batch)) * BETA
        n_levels, errs = check_slice(c, [(vk, vt)], f"gamma4 {label}", diagnose=g4_diagnose,
                                     misses=g4_misses)
        control = leaf_control(label, c, vk, vt)
        if order >= 5 and mode == "fused":
            leaf_report["checks"][f"gamma4 order {order}"] = check_leaf_kernels(
                f"order-{order} Gamma4", c.tables, para_o.totalLoopNum, para_o.totalTauNum)
            leaf_report["times"][f"gamma4 order {order}"] = leaf_times(
                f"order-{order} Gamma4 fused", c, para_o.totalLoopNum, para_o.totalTauNum)
        rel = errs[batch][0]
        k = int(np.argmax(rel))
        print(f"gamma4: {label}: slots, edges, levels, buckets, ProdPlans {counts[0]}, roots and "
              f"leaves {counts[1]} (the CPU lowering's {GAMMA4[order, mode]}); f32 kernel vs "
              f"f64 plain on the card, batch {batch}: {n_levels} level launches a pass, worst "
              f"per-root max|d|/max|ref| {rel[k]:.3e} at root {k} (limit {SLICE_TOL:g})",
              flush=True)
        if counts != GAMMA4[order, mode]:
            fail(f"gamma4 {label}: {counts}, not the CPU lowering's {GAMMA4[order, mode]}")
        lerr = {comp: check_levels(low, rand_w(low.num_slots, CHECK_BATCH, torch.float32),
                                   torch.float32, None, comp,
                                   f"gamma4 {label} batch {CHECK_BATCH} compensated={comp}")
                for comp in (False, True)}
        print(f"gamma4: level launch = plain on every level of the {label} lowering, f32, batch "
              f"{CHECK_BATCH}: Kahan max|diff| {lerr[True]:.3e} (must be 0), plain sums "
              f"max|diff| {lerr[False]:.3e}", flush=True)
        w = rand_w(low.num_slots, BATCH, torch.float32)
        tabs = tables_of(low, torch.float32)
        ld, per_level, bounds = level_pass_ms(low, w, tabs)
        plain = sum(queued_ms(lambda t=t: level_plain(w, t)) for t in tabs)
        bound = sum(b["ms"] for b in bounds)
        lib = library_ms(low, w, tabs) if mode == "bucketed" else None
        lib_line = ("" if lib is None else f"; torch.sparse.mm of each SumBucket's CSR matrix "
                    f"with w, back to back, {lib:.4f} ms")
        print(f"gamma4 time: {label} batch {BATCH} f32, the buckets of a pass, device, back to "
              f"back: {len(tabs)} level launches {ld:.4f} ms ({bound / ld:.3f} of the bound "
              f"{bound:.4f} ms = distinct rows per level + written rows over 3.35 TB/s); "
              f"plain, level by level, {plain:.4f} ms{lib_line}  [{smi}]", flush=True)
        levels_line(f"gamma4 levels: {label} batch {BATCH} f32", per_level, bounds)
        rep = {"launches_per_pass": n_levels, "max_rel_err": max(rel),
               "max_abs_err": lerr[False], "max_abs_err_kahan": lerr[True], "ms": ld,
               "plain_ms": plain, "bound_ms": bound,
               "bound_by": max(bounds, key=lambda b: b["ms"])["by"], "library_ms": lib,
               "share_of_bound": bound / ld, "batch": BATCH,
               "level_shares": [b["ms"] / t for t, b in zip(per_level, bounds)],
               "leaf_control": control}
        mc = mc_lines(c, para_o, GAMMA4_MC[order, mode], f"gamma4 mc: {label}")
        rep.update({f"mc_{b}": m for b, m in mc.items()})
        if order >= 5:
            rep["split"] = busy_split(label, c, para_o, w, ld, mc[BATCH]["busy_ms"])
        del w, tabs
        torch.cuda.empty_cache()
        return rep

    def big_pass(order, mode, c, batch):
        """One graph pass of c at batch, whose buffer passes 2^31 elements,
        with return_all=True, against three windows of WINDOW columns of the
        same leaf values: every row bit for bit (g4.differing_rows)."""
        low = c.lowered
        graph_all = make_evaluator(low, device=dev, dtype=torch.float32, return_all=True)
        para_o = g4.vertex4_para(order)
        vk = torch.randn((3, para_o.totalLoopNum, batch), generator=dev_gen, device=dev)
        vt = torch.rand((para_o.totalTauNum, batch), generator=dev_gen, device=dev) * BETA
        leaves = c.leaf_fn(vk, vt)
        del vk, vt
        torch.cuda.synchronize()
        zero_levels()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        w = graph_all(leaves)
        e1.record()
        torch.cuda.synchronize()
        full_ms, n_launch = e0.elapsed_time(e1), levels_run()
        finite = bool(torch.isfinite(w[torch.as_tensor(low.root_slots, device=dev)]).all())
        diff = g4.differing_rows(graph_all, leaves, w, WINDOW)
        n = w.numel()
        print(f"gamma4 2^31: order {order} {mode}, batch {batch}: w {low.num_slots} x {batch} f32, "
              f"{n} elements = {n / 2 ** 31:.3f} x 2^31 ({n * 4 / 1e9:.1f} GB), largest element "
              f"offset {n - 1}, rows from {-(-2 ** 31 // batch)} on lie past element 2^31; "
              f"full pass {full_ms:.2f} ms with {n_launch} level launches, roots finite "
              f"{finite}; rows differing from the full pass in the first, a middle and the "
              f"last {WINDOW} columns run alone: {diff}  [{smi}]", flush=True)
        if n < 2 ** 31 or any(diff) or not finite:
            fail(f"gamma4 2^31 order {order} {mode}: {n} elements, windows differ in {diff} rows, "
                 f"roots finite {finite}")
        del w, leaves, graph_all
        torch.cuda.empty_cache()
        return {"batch": batch, "elements": n, "full_pass_ms": full_ms,
                "differing_rows": diff}

    # a root of orders 3-6 outside SLICE_TOL fails the run at its end, after
    # the phase's other checks and times
    g4_report, g4_big, g4_misses = {3: {}, 5: {}, 6: {}}, [], []

    # order 3, generated and lowered here
    t0 = time.perf_counter()
    roots3, para3 = g4.vertex4_roots(3)
    c3 = {mode: compile_evaluator(roots3, max_loop_num=para3.totalLoopNum, beta=BETA, kF=KF,
                                  lam=LAM, device=dev, dtype=torch.float32, sum_mode=mode)
          for mode in ("fused", "bucketed")}
    print(f"gamma4 host: order 3 generated, optimized and lowered both ways in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for mode, c in c3.items():
        g4_report[3][mode] = g4_lowering(3, mode, c)
    # scaling.py at order 3 on local meshes of 1, 2 and 4 ranks
    pts = (scaling.sample_axis_points(c3["fused"], para3, (1, 2, 4), BATCH, 10, dev)
           + scaling.graph_axis_points(roots3, (1, 2, 4), 1024, 10, dev))
    for p in pts:
        print(f"scaling: {json.dumps(p)}", flush=True)
    for line in scaling.table(pts).splitlines():
        print(f"scaling: {line}  [{smi}]", flush=True)
    del c3, roots3
    phase("gamma4: order 3")

    # scan_merge.py and probe_split.py at order 4, on the main path's roots
    for row in scan_merge.scan(roots, para, (0, 2000), (BATCH, 4 * BATCH), device=dev):
        print(f"scan_merge: {json.dumps(row)}  [{smi}]", flush=True)
        if row["threshold"] == 0 and row["buckets"] != len(buckets_of(compiled["fused"].lowered)):
            fail(f"scan_merge: {row['buckets']} buckets at threshold 0, not the fused slice's")
    for cse, cnt in probe_split.cse_counts(roots).items():
        print(f"probe_split: order 4 bucketed, cse={cse}: {json.dumps(cnt)}", flush=True)
    split = probe_split.split_ms(compiled["bucketed"], para, BATCH, dev)
    traffic = probe_split.graph_traffic_bytes(compiled["bucketed"].lowered, BATCH)
    print(f"probe_split: order 4 bucketed batch {BATCH} f32, device ms a call: leaf phase "
          f"{split['leaf_ms']:.4f}, graph phase {split['graph_ms']:.4f}; graph-phase traffic "
          f"{traffic / 1e9:.3f} GB -> {traffic / split['graph_ms'] / 1e6:.0f} GB/s  [{smi}]",
          flush=True)
    phase("gamma4: scan_merge and probe_split at order 4")

    # order 5 from the child's artifacts
    paths5 = wait_child(5)
    c5 = {}
    for mode in ("fused", "bucketed"):
        t0 = time.perf_counter()
        c5[mode] = from_artifact(paths5[mode])
        print(f"gamma4 host: order 5 {mode} artifact loaded and its evaluators built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        g4_report[5][mode] = g4_lowering(5, mode, c5[mode])
    # probe_structure.py on the order-5 fused lowering
    st = probe_structure.structure(c5["fused"].lowered)
    for line in probe_structure.report(st).splitlines():
        print(f"probe_structure: order 5 fused: {line}", flush=True)
    vk = torch.randn((3, c5["fused"].max_loop_num, BATCH), generator=dev_gen, device=dev)
    vt = torch.rand((g4.vertex4_para(5).totalTauNum, BATCH), generator=dev_gen,
                    device=dev) * BETA
    pt = probe_structure.phase_ms(c5["fused"].leaf_fn, c5["fused"].graph_fn, c5["fused"].fn,
                                  vk, vt)
    print(f"probe_structure: order 5 fused batch {BATCH} f32: leaf {pt['leaf_ms']:.4f} ms, graph "
          f"{pt['graph_ms']:.4f} ms, full {pt['full_ms']:.4f} ms -> "
          f"{BATCH / pt['full_ms'] * 1e3:.0f} samples/s; graph-phase edges/s "
          f"{st['edges'] * BATCH / pt['graph_ms'] / 1e6:.1f} G  [{smi}]", flush=True)
    del vk, vt
    # config 5 at its own order 5, and certify_sharded at 8 graph ranks
    low_c5, tables_c5 = load_artifact(paths5["config5"])
    stats_c5, c5_bitwise = serve_check(low_c5, tables_c5, "gamma4: config5 order 5")
    print(f"gamma4: config5 order 5 plan, 4 graph ranks: full slots {stats_c5.full_slots}, slots "
          f"a rank {stats_c5.local_slots}, halo {stats_c5.halo_bytes_per_sample()} B/sample f32, "
          f"pad {stats_c5.halo_pad_overhead:.3f}, early {stats_c5.early_share:.3f}", flush=True)
    low_c8, _ = load_artifact(paths5["certify8"])
    try:
        cert5 = certify_sharded.certify(5, 8, BATCH, dev, lowered=low_c8,
                                        live_slots=c5["fused"].lowered.num_slots)
    except RuntimeError as err:
        fail(f"gamma4: certify_sharded at order 5: {err}")
    print(f"gamma4: certify_sharded {json.dumps(cert5)}", flush=True)
    g4_report[5]["config5"] = {
        "full_slots": int(stats_c5.full_slots), "local_slots": int(stats_c5.local_slots),
        "halo_bytes_per_sample": int(stats_c5.halo_bytes_per_sample()),
        "pad": float(stats_c5.halo_pad_overhead), "early": float(stats_c5.early_share),
        "mc_bit_for_bit": c5_bitwise, "certify8": cert5}
    del low_c5, tables_c5, low_c8
    torch.cuda.empty_cache()
    phase("gamma4: order 5")

    # order 6 from the child's artifacts
    paths6 = wait_child(6)
    c6 = {}
    for mode in ("fused", "bucketed"):
        t0 = time.perf_counter()
        c6[mode] = from_artifact(paths6[mode])
        print(f"gamma4 host: order 6 {mode} artifact loaded and its evaluators built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        g4_report[6][mode] = g4_lowering(6, mode, c6[mode])
    phase("gamma4: order 6")

    # past 2^31 elements of w, bit for bit against narrow windows
    for order, mode, batch in BIG_PASSES:
        g4_big.append({"order": order, "mode": mode,
                       **big_pass(order, mode, (c5 if order == 5 else c6)[mode], batch)})
    for mode in ("fused", "bucketed"):
        jit_keep[f"gamma4 order 6 {mode}"] = (c6[mode], g4.vertex4_para(6))
    del c5, c6
    torch.cuda.empty_cache()
    phase("gamma4: past 2^31")
    if g4_misses:
        print(json.dumps({"gamma4_slice_misses": g4_misses}), flush=True)
        fail("gamma4: the float32 pass left SLICE_TOL of the float64 plain path: "
             + "; ".join(f"{m['check']}, batch {m['batch']}, root {m['root']}: "
                         f"{m['max_rel_err']:.3e}" for m in g4_misses))


    # -- 10a. the eager pass from its launch plans
    fused4, para4_ = jit_keep["config 4 fused"]
    plan_report = launch_plan_checks(dev, smi, (
        ("order-4 Gamma4 fused", compiled["fused"], para.totalLoopNum, para.totalTauNum),
        ("config 4 fused", fused4, para4_.totalLoopNum, para4_.totalTauNum)))
    phase("launch plan")

    # -- 10b. stretches of thin levels as column runs
    col_report = column_run_checks(dev, smi, column_run_cases(dev, {
        "order-4 Gamma4 fused": (compiled["fused"], para.totalLoopNum, para.totalTauNum),
        "config 4 fused": (fused4, para4_.totalLoopNum, para4_.totalTauNum)}))
    del fused4, para4_
    torch.cuda.empty_cache()
    phase("column runs")

    # -- 11. the whole pass captured as CUDA graphs: jit=True
    def host_ms(fn, n=JIT_HOST_CALLS):
        """The host's time per call of fn, n calls enqueued behind a sleep
        kernel, so that the device never makes the host wait; None where the
        sleep ended before the host was done: a call waited for the device
        (a copy from pageable host memory, an allocation that frees cached
        blocks)."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(JIT_SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out = (time.perf_counter() - t0) / n * 1e3
        waited = slept.query()
        torch.cuda.synchronize()
        return None if waited else out

    def pass_clocks(fn, queued=True):
        """One pass's clocks: the profiler's busy time, level and leaf
        kernels a call and the wall of the same traced calls
        (profile_calls), the wall untraced (events around 20 calls), the
        device time with the host out of the way (queued_ms; not where fn
        waits for the device) and the host's time a call (host_ms)."""
        by_kernel, n_level, n_leaf, busy, traced = profile_calls(fn)
        return {"busy_ms": busy, "kernels_summed_ms": sum(by_kernel.values()),
                "level_kernels": n_level,
                "leaf_kernels": n_leaf, "traced_wall_ms": traced,
                "wall_ms": wall_ms(fn, n=20), "queued_ms": queued_ms(fn) if queued else None,
                "host_ms": host_ms(fn)}

    def fmt_ms(x):
        return "n/a (waits for the device)" if x is None else f"{x:.4f}"

    def held(eager, got, plain64):
        """Captured outputs got (a list) against eager, a function of no
        arguments: bit for bit where two eager calls are, else within
        SLICE_TOL of plain64() per root (or channel), and the line says so."""
        e1, e2 = eager(), eager()
        torch.cuda.synchronize()
        if torch.equal(e1, e2):
            ok = all(g.shape == e1.shape and torch.equal(g, e1) for g in got)
            return ok, "two eager passes bit for bit; captured vs eager bit for bit: " + str(ok)
        ref = plain64()
        scale = ref.abs().max(dim=1).values.clamp_min(torch.finfo(torch.float64).tiny)
        rel = max(((g.double() - ref).abs().max(dim=1).values / scale).max().item() for g in got)
        return rel <= SLICE_TOL, (f"two eager passes differ (max|diff| "
                                  f"{(e1 - e2).abs().max().item():.3e}), so the captured pass "
                                  f"is held to the f64 plain path: worst {rel:.3e} (limit "
                                  f"{SLICE_TOL:g})")

    def jit_case(label, c, para_c, check_batches, mc_batches, cj=None):
        """One captured path: c.jitted() (or cj, compile_evaluator(jit=True)),
        its first call and a replay at each of check_batches against the
        eager pass; at each of mc_batches mc_run(jit=True) against
        mc_run(jit=False) on one seed, then the eager and the captured pass
        side by side: samples/s (in turns), wall, busy, idle share, the
        host's time a pass (a replay), level kernels a pass by the
        profiler's kernel names, and the peak of allocated memory."""
        n_levels = sum(1 for lvl in c.lowered.levels if level_buckets(lvl))
        cj = cj if cj is not None else c.jitted()
        ref_leaf = make_leaf_evaluator(c.tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                                       dtype=torch.float64)
        ref_graph = make_evaluator(c.lowered, device=dev, dtype=torch.float64, kernel=False)
        rep = {"levels": n_levels, "check": {}, "mc": {}}
        for batch in check_batches:
            vk = torch.as_tensor(gen.standard_normal((3, para_c.totalLoopNum, batch)),
                                 device=dev)
            vt = torch.as_tensor(gen.random((para_c.totalTauNum, batch)) * BETA, device=dev)
            got = [cj(vk, vt), cj(vk, vt)]
            ok, how = held(lambda: c(vk, vt), got,
                           lambda: ref_graph(ref_leaf(vk, vt)))
            print(f"jit: {label}, batch {batch} f32, the captured pass (its first call, then a "
                  f"replay) against the eager pass on the same inputs: {how}", flush=True)
            if not ok or not torch.isfinite(got[0]).all():
                fail(f"jit {label}, batch {batch}: the captured pass left the eager one")
            rep["check"][batch] = how
            del vk, vt, got
        del cj, ref_leaf, ref_graph
        torch.cuda.empty_cache()
        for batch in mc_batches:
            kw = dict(n_loop=para_c.totalLoopNum, num_tau=para_c.totalTauNum, batch=batch,
                      n_roots=len(c.lowered.root_slots), device=dev, dtype=torch.float32,
                      beta=BETA)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            want = mc_run(c.fn, iters=3, seed=SEED, **kw)
            torch.cuda.synchronize()
            mem_e = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loop = CapturedLoop(c, **kw)
            kernel_fn.launches = 0
            zero_levels()
            leaf_eval.leaf_eval.launches = 0
            got = loop.run(SEED, 3)
            torch.cuda.synchronize()
            mem_j = torch.cuda.max_memory_allocated()
            counted = (levels_run(), kernel_fn.launches, leaf_launches())
            if counted != (3 * n_levels, 0, 3):
                fail(f"jit {label} mc, batch {batch}: 3 replays counted {counted} level, "
                     f"bucket and leaf launches, expected {(3 * n_levels, 0, 3)}: a replay "
                     f"counts its graph's launch manifest, the eager pass's launches")
            draws = "the eager draws"
            if not torch.equal(got, want):
                # the captured Philox stream may differ from the eager one:
                # hold the eager pass on the static draws of one replay
                loop.run(SEED, 1)
                vk, vt, acc = loop.varK.clone(), loop.varT.clone(), loop.acc.clone()
                ok, how = held(lambda: c.fn(vk, vt).sum(dim=1)[None], [acc[None]],
                               lambda: ref_graph_sum(c, vk, vt))
                draws = f"draws of its own (not the eager stream); one replay on them: {how}"
                if not ok:
                    fail(f"jit {label} mc, batch {batch}: the captured loop's sums differ from "
                         f"the eager pass on the same draws")
            print(f"jit mc: {label}, batch {batch} f32: mc_run(jit=True) vs mc_run(jit=False), "
                  f"seed {SEED}, 3 passes: bit for bit {torch.equal(got, want)}; the captured "
                  f"loop ran on {draws}", flush=True)

            def one_e():
                mc_run(c.fn, iters=1, seed=SEED, **kw)

            def one_j():
                loop.run(SEED, 1)

            clocks = {"eager": pass_clocks(one_e), "captured": pass_clocks(one_j)}
            clocks["captured"]["host_ms_replay"] = host_ms(loop.graph.replay)
            iters = min(100, max(10, int(MC_RUN_MS / clocks["eager"]["wall_ms"])))
            sps = {"eager": [], "captured": []}
            for mode in ("eager", "captured", "captured", "eager"):
                sps[mode].append(mc_samples_per_s(c if mode == "captured" else c.fn,
                                                  iters=iters, reps=3,
                                                  jit=mode == "captured", **kw))
            for mode, m in clocks.items():
                m["samples_per_s"] = float(np.mean(sps[mode]))
                m["idle"] = 1 - m["busy_ms"] / m["traced_wall_ms"]
                m["peak_gib"] = (mem_e if mode == "eager" else mem_j) / 2 ** 30
            e, j = clocks["eager"], clocks["captured"]
            print(f"jit time: {label}, batch {batch} f32, eager / captured: samples/s "
                  f"{e['samples_per_s']:.1f} / {j['samples_per_s']:.1f} "
                  f"({j['samples_per_s'] / e['samples_per_s']:.2f}x; {iters} passes a run, in "
                  f"turns); a pass: wall {e['wall_ms']:.4f} / {j['wall_ms']:.4f} ms, traced "
                  f"{e['traced_wall_ms']:.4f} / {j['traced_wall_ms']:.4f} ms, busy (profiler, "
                  f"same run) {e['busy_ms']:.4f} / {j['busy_ms']:.4f} ms (kernels' own times "
                  f"summed {e['kernels_summed_ms']:.4f} / {j['kernels_summed_ms']:.4f}), idle "
                  f"{e['idle']:.3f} / {j['idle']:.3f}, device with the host out of the way "
                  f"(queued_ms) {fmt_ms(e['queued_ms'])} / {fmt_ms(j['queued_ms'])} ms, host "
                  f"{fmt_ms(e['host_ms'])} / {fmt_ms(j['host_ms'])} ms (the replay alone "
                  f"{fmt_ms(j['host_ms_replay'])}); level kernels a pass by the profiler's names "
                  f"{e['level_kernels']:.1f} / {j['level_kernels']:.1f} (levels that hold "
                  f"buckets or plans: {n_levels}); leaf_eval kernels a pass "
                  f"{e['leaf_kernels'][0]:.1f} / {j['leaf_kernels'][0]:.1f}; peak allocated "
                  f"{e['peak_gib']:.3f} / "
                  f"{j['peak_gib']:.3f} GiB (allocated before: {base / 2 ** 30:.3f})  [{smi}]",
                  flush=True)
            if not (once_each(e["leaf_kernels"]) and once_each(j["leaf_kernels"])):
                fail(f"jit {label}, batch {batch}: leaf kernels a pass eager "
                     f"{e['leaf_kernels']}, captured {j['leaf_kernels']}: expected once")
            if any(m["busy_ms"] > m["traced_wall_ms"] for m in (e, j)):
                fail(f"jit {label}, batch {batch}: device busy above the wall of the same "
                     f"traced passes: a faulty clock reading")
            rep["mc"][batch] = {"bit_for_bit": torch.equal(got, want), **{
                f"{mode}_{k}": v for mode, m in clocks.items() for k, v in m.items()}}
            del loop, want, got
            torch.cuda.empty_cache()
        return rep

    def ref_graph_sum(c, vk, vt):
        """The f64 plain pass's roots summed over the batch, as a [1, R] row."""
        leaf = make_leaf_evaluator(c.tables, beta=BETA, kF=KF, lam=LAM, device=dev,
                                   dtype=torch.float64)
        return make_evaluator(c.lowered, device=dev, dtype=torch.float64, kernel=False)(
            leaf(vk, vt)).sum(dim=1)[None]

    print("jit: a replay counts its graph's launch manifest in the launch counters, the "
          "eager pass's launches a pass (jit mc checks it); the jit time lines count level "
          "kernels by the profiler's kernel names", flush=True)
    jit_report = {}
    for mode in ("fused", "bucketed"):
        label = f"order-4 Gamma4 {mode}"
        cj = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
                               device=dev, dtype=torch.float32, sum_mode=mode, jit=True)
        jit_report[label] = jit_case(label, compiled[mode], para,
                                     (BATCH, RAGGED_BATCH, 2 * BATCH), JIT_MC_BATCHES, cj=cj)
        del cj
    phase("jit: order-4 Gamma4")
    for label, check_batches, mc_batches in (
            ("config 4 fused", (2 * BATCH,), JIT_MC_BATCHES),
            ("GV sigma 6 fused", (BATCH,), JIT_MC_BATCHES),
            ("gamma4 order 6 fused", (BATCH,), (BATCH, 2 * BATCH)),
            ("gamma4 order 6 bucketed", (BATCH,), (BATCH,))):
        c_, para_c = jit_keep.pop(label)
        jit_report[label] = jit_case(label, c_, para_c, check_batches, mc_batches)
        del c_
        torch.cuda.empty_cache()
        phase(f"jit: {label}")

    # the Hubbard atom captured: two U through one graph, sigma_mc, times
    for order in HUBBARD_ORDERS:
        hs = ha.build_sigma_evaluator(order, HUBBARD_BETA, device=dev, dtype=torch.float32)
        hj = ha.build_sigma_evaluator(order, HUBBARD_BETA, device=dev, dtype=torch.float32,
                                      jit=True)
        plain_hs = ha.build_sigma_evaluator(order, HUBBARD_BETA, device=dev,
                                            dtype=torch.float64, kernel=False)
        hub_varT = torch.as_tensor(gen.random((hs.num_tau, HUBBARD_BATCH)) * HUBBARD_BETA,
                                   device=dev)
        hub_varT[0] = 0.0
        hows = []
        for u in (HUBBARD_U, 0.5 * HUBBARD_U):
            got = [hj.fn(hub_varT, u), hj.fn(hub_varT, u)]
            ok, how = held(lambda: hs.fn(hub_varT, u), got,
                           lambda: plain_hs.fn(hub_varT, u))
            hows.append(f"U {u}: {how}")
            if not ok or got[0].shape != (2, HUBBARD_BATCH):
                fail(f"jit Hubbard order {order}, U {u}: the captured pass left the eager one")
        mean, err = ha.sigma_mc(order, HUBBARD_U, HUBBARD_BETA, batch=HUBBARD_BATCH,
                                chunks=HUBBARD_CHUNKS, seed=order, device=dev,
                                dtype=torch.float32, jit=True)
        expect, ok, z = against_series(order, mean, err)
        print(f"jit: Hubbard order {order}, batch {HUBBARD_BATCH} f32, two U through one "
              f"captured evaluator: " + "; ".join(hows) + f"; sigma_mc(jit=True) "
              f"{HUBBARD_BATCH} x {HUBBARD_CHUNKS}, seed {order}: mean {mean:.6f}, stderr "
              f"{err:.6f}, series {expect:.6f}, (mean - series)/stderr {z}", flush=True)
        if not ok:
            fail(f"jit Hubbard order {order}: sigma_mc(jit=True) {mean} (stderr {err}) against "
                 f"the series {expect}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the eager call copies U from the host, which waits for the device:
        # no queued_ms of it
        clocks = {"eager": pass_clocks(lambda: hs.fn(hub_varT, HUBBARD_U), queued=False)}
        mem_e = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        clocks["captured"] = pass_clocks(lambda: hj.fn(hub_varT, HUBBARD_U))
        mem_j = torch.cuda.max_memory_allocated()
        for mode, m in clocks.items():
            m["samples_per_s"] = HUBBARD_BATCH / m["wall_ms"] * 1e3
            m["idle"] = 1 - m["busy_ms"] / m["traced_wall_ms"]
            m["peak_gib"] = (mem_e if mode == "eager" else mem_j) / 2 ** 30
        e, j = clocks["eager"], clocks["captured"]
        print(f"jit time: Hubbard order {order}, batch {HUBBARD_BATCH} f32, one call of fn, "
              f"eager / captured: samples/s {e['samples_per_s']:.0f} / {j['samples_per_s']:.0f} "
              f"({j['samples_per_s'] / e['samples_per_s']:.2f}x); wall {e['wall_ms']:.4f} / "
              f"{j['wall_ms']:.4f} ms, traced {e['traced_wall_ms']:.4f} / "
              f"{j['traced_wall_ms']:.4f} ms, busy (profiler, same run) {e['busy_ms']:.4f} / "
              f"{j['busy_ms']:.4f} ms, idle "
              f"{e['idle']:.3f} / {j['idle']:.3f}, queued_ms {fmt_ms(e['queued_ms'])} / "
              f"{fmt_ms(j['queued_ms'])} ms, host {fmt_ms(e['host_ms'])} / {fmt_ms(j['host_ms'])} ms; level "
              f"kernels a call {e['level_kernels']:.1f} / {j['level_kernels']:.1f} (expected "
              f"{HUBBARD_BUCKET_LEVELS[order]}); peak allocated {e['peak_gib']:.3f} / "
              f"{j['peak_gib']:.3f} GiB  [{smi}]", flush=True)
        if any(m["busy_ms"] > m["traced_wall_ms"] for m in (e, j)):
            fail(f"jit Hubbard order {order}: device busy above the wall of the same traced "
                 f"calls: a faulty clock reading")
        jit_report[f"Hubbard order {order}"] = {
            "two_U": hows, "sigma_mc_jit": [mean.real, mean.imag, err.real, err.imag],
            **{f"{mode}_{k}": v for mode, m in clocks.items() for k, v in m.items()}}
        del hs, hj, plain_hs, hub_varT, got
        torch.cuda.empty_cache()
    phase("jit: Hubbard atom")

    # -- 12. the sharded passes captured: jit=True on the parallel layer
    from feynmandiagram_tpu_torch.benchmarks import probe_bucket_fusion

    def halo_kernel(name):
        """Whether a kernel of the profiler's is a row gather or a
        concatenation, the halo exchange of a local mesh (and, bucketed,
        the prod groups' reads of the halo), not the level kernel."""
        return ("gather_reduce" not in name
                and any(k in name for k in ("index", "gather", "Cat")))

    def shard_clocks(fn, n, queued, host_calls):
        """pass_clocks of a sharded call, with the device time of its halo
        gathers (halo_kernel) from the same trace.  A trace whose level
        kernels a call are no whole number lost kernels (late in this
        script the profiler drops a few: 518 of 520 in every trace of one
        case, where a fresh process counts 520) and is taken again, up to
        TRACE_TRIES times.  queued_ms only where queued: an eager MC step
        enqueues more launches than the queue holds while the device
        sleeps."""
        for tries in range(1, TRACE_TRIES + 1):
            by_kernel, n_level, _, busy, traced = profile_calls(fn, n)
            if n_level == int(n_level):
                break
        return {"busy_ms": busy, "level_kernels": n_level, "traces": tries,
                "halo_ms": sum(t for k, t in by_kernel.items() if halo_kernel(k)),
                "traced_wall_ms": traced,
                "wall_ms": wall_ms(fn, n=2 * n), "queued_ms": queued_ms(fn) if queued else None,
                "host_ms": host_ms(fn, n=host_calls)}

    def shard_case(label, eager, captured, samples=None, n=10, queued=False,
                   host_calls=JIT_HOST_CALLS):
        """A captured sharded call against its eager one, both functions of
        no arguments: the captured call's first run (capture and replay)
        and a replay after an eager call (which reuses memory that a graph
        must not have freed) bit for bit with eager; with samples (the
        samples a call evaluates), eager and captured clocks side by side:
        samples/s, wall, busy, idle, device with the host out of the way,
        host ms a call, level kernels a call by the profiler's names (equal
        both ways), the halo gathers' device time and peak allocated
        memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = eager()
        torch.cuda.synchronize()
        mem_e = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = [captured()]
        torch.cuda.synchronize()
        mem_j = torch.cuda.max_memory_allocated()
        eager()
        got.append(captured())
        torch.cuda.synchronize()
        ok = all(g.shape == want.shape and torch.equal(g, want) for g in got)
        print(f"jit sharded: {label}: captured (its first call, then a replay after an eager "
              f"call) vs eager bit for bit: {ok}", flush=True)
        if not ok:
            fail(f"jit sharded {label}: the captured call left the eager one: max|diff| "
                 f"{max((g - want).abs().max().item() for g in got):.3e}")
        rep = {"bit_for_bit": ok}
        if samples is None:
            return rep
        clocks = {"eager": shard_clocks(eager, n, queued, host_calls),
                  "captured": shard_clocks(captured, n, queued, host_calls)}
        for mode, m in clocks.items():
            m["samples_per_s"] = samples / m["wall_ms"] * 1e3
            m["idle"] = 1 - m["busy_ms"] / m["traced_wall_ms"]
            m["peak_gib"] = (mem_e if mode == "eager" else mem_j) / 2 ** 30
        e, j = clocks["eager"], clocks["captured"]
        print(f"jit shard time: {label}, {samples} samples a call, eager / captured: samples/s "
              f"{e['samples_per_s']:.0f} / {j['samples_per_s']:.0f} "
              f"({j['samples_per_s'] / e['samples_per_s']:.2f}x); a call: wall "
              f"{e['wall_ms']:.4f} / {j['wall_ms']:.4f} ms, traced {e['traced_wall_ms']:.4f} / "
              f"{j['traced_wall_ms']:.4f} ms, busy (profiler, same run) {e['busy_ms']:.4f} / "
              f"{j['busy_ms']:.4f} ms, idle {e['idle']:.3f} / {j['idle']:.3f}, "
              + (f"queued_ms {fmt_ms(e['queued_ms'])} / {fmt_ms(j['queued_ms'])} ms, " if queued
                 else "") + f"host "
              f"{fmt_ms(e['host_ms'])} / {fmt_ms(j['host_ms'])} ms (captured: copy in, replay, "
              f"copy out); level kernels a call by the profiler's names "
              f"{e['level_kernels']:.1f} / {j['level_kernels']:.1f} (traces taken "
              f"{e['traces']} / {j['traces']}); halo gathers (index and "
              f"cat kernels) {e['halo_ms']:.4f} / {j['halo_ms']:.4f} ms; peak allocated "
              f"{e['peak_gib']:.3f} / {j['peak_gib']:.3f} GiB  [{smi}]", flush=True)
        # every call of fn launches the same kernels, so the true count a
        # call is a whole number, at least the mean of a trace that lost some
        if math.ceil(e["level_kernels"]) != math.ceil(j["level_kernels"]):
            fail(f"jit sharded {label}: {j['level_kernels']} level kernels a replay, "
                 f"{e['level_kernels']} eager")
        if any(m["busy_ms"] > m["traced_wall_ms"] for m in (e, j)):
            fail(f"jit sharded {label}: device busy above the wall of the same traced calls: a "
                 f"faulty clock reading")
        rep.update({f"{mode}_{k}": v for mode, m in clocks.items() for k, v in m.items()})
        return rep

    def leaf_block(low_s, batch):
        return torch.as_tensor(gen.uniform(0.5, 1.5, (low_s.num_leaves - len(low_s.const_slots),
                                                      batch)), dtype=torch.float32, device=dev)

    jit_shard_report = {}
    mesh_22 = Mesh([("graph", 2), ("batch", 2)], device=dev)
    for mode, low_s in shard_keep.items():
        for mesh_s, batch_axis, batches, tag in (
                (mesh_g, None, (BATCH, RAGGED_BATCH), f"{N_GRAPH} local graph ranks"),
                (mesh_22, "batch", SHARD_2X2_BATCHES, "a local 2 x 2 graph x batch mesh")):
            sh_e, sh_j = (make_graph_sharded_evaluator(low_s, mesh_s, batch_axis=batch_axis,
                                                       dtype=torch.float32, jit=jit)
                          for jit in (False, True))
            for batch in batches:
                leaves = leaf_block(low_s, batch)
                timed = batch == BATCH and (mode == "fused" or batch_axis is None)
                label = f"order-4 Gamma4 {mode} sharded pass on {tag}, batch {batch} f32"
                jit_shard_report[label] = shard_case(
                    label, lambda: sh_e(leaves), lambda: sh_j(leaves),
                    samples=batch if timed else None, queued=True)
                del leaves
            del sh_e, sh_j
            torch.cuda.empty_cache()
    phase("jit sharded: graph axis")

    # the sample axis, on a local 4-rank mesh and on the one-rank NCCL mesh
    c = compiled["fused"]
    vk32 = torch.randn((3, para.totalLoopNum, BATCH), generator=dev_gen, device=dev)
    vt32 = torch.rand((para.totalTauNum, BATCH), generator=dev_gen, device=dev) * BETA

    def sample_cases(mesh_s, tag, timed):
        f_e, f_j = (shard_compiled(c, mesh_s, jit=jit) for jit in (False, True))
        s_e, s_j = (make_mc_step(c, mesh_s, beta=BETA, jit=jit) for jit in (False, True))
        bpd = BATCH // mesh_s.size if timed else SAMPLE_MC_BATCH
        out = {f"shard_compiled, {tag}": shard_case(
            f"order-4 Gamma4 fused shard_compiled on {tag}, batch {BATCH} f32",
            lambda: f_e(vk32, vt32), lambda: f_j(vk32, vt32), BATCH if timed else None)}
        out[f"make_mc_step, {tag}"] = shard_case(
            f"order-4 Gamma4 fused make_mc_step on {tag}, {bpd} a rank, seed {SEED}",
            lambda: s_e(SEED, bpd), lambda: s_j(SEED, bpd),
            bpd * mesh_s.size if timed else None)
        return out

    jit_shard_report.update(sample_cases(make_sample_mesh(N_GRAPH, device=dev),
                                         f"a local {N_GRAPH}-rank sample mesh", True))
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            backend = dist.get_backend()
            jit_shard_report.update(sample_cases(make_sample_mesh(device=dev),
                                                 f"the one-rank {backend} mesh", False))
            # the graph axis over the process group: the halos through NCCL
            mesh_d = Mesh([("graph", N_GRAPH)], device=dev, groups={"graph": dist.group.WORLD})
            sh_e, sh_j = (make_graph_sharded_evaluator(shard_keep["fused"], mesh_d,
                                                       dtype=torch.float32, jit=jit)
                          for jit in (False, True))
            leaves = leaf_block(shard_keep["fused"], BATCH)
            label = (f"order-4 Gamma4 fused sharded pass, its {N_GRAPH}-rank graph axis over the "
                     f"one-rank {backend} group (the halos through {backend}), batch {BATCH} f32")
            jit_shard_report[label] = shard_case(label, lambda: sh_e(leaves), lambda: sh_j(leaves))
            del sh_e, sh_j, leaves
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    if backend != "nccl":
        fail(f"jit sharded: the process group's backend is {backend}, not nccl")
    del vk32, vt32
    torch.cuda.empty_cache()
    phase("jit sharded: sample axis")

    # config 5 at its own order 5: serve(jit=True) against serve(jit=False)
    low_c5, tables_c5 = load_artifact(paths5["config5"])
    served = {jit: config5_serving.serve(low_c5, tables_c5, device=dev, batch_per_device=BATCH,
                                         iters=SHARD_MC_ITERS, seed=SEED, jit=jit)
              for jit in (False, True)}
    (m_e, step_e, mesh_c5), (m_j, step_j, _) = served[False], served[True]
    ok = torch.equal(m_e, m_j)
    print(f"jit sharded: config5 order 5, serve(jit=True) vs serve(jit=False) on the "
          f"{mesh_c5.shape} mesh, {BATCH} a device, {SHARD_MC_ITERS} iterations: bit for bit "
          f"{ok}", flush=True)
    if not ok:
        fail(f"jit sharded: config5 order 5 captured means differ from eager: max|diff| "
             f"{(m_e - m_j).abs().max().item():.3e}")
    label = (f"config5 order 5 MC step on the {mesh_c5.shape} mesh, {BATCH} a device, "
             f"{SHARD_MC_ITERS} iterations, seed {SEED + 1}")
    jit_shard_report[label] = shard_case(
        label, lambda: step_e(SEED + 1, BATCH, SHARD_MC_ITERS),
        lambda: step_j(SEED + 1, BATCH, SHARD_MC_ITERS),
        BATCH * mesh_c5.shape["batch"] * SHARD_MC_ITERS, n=C5_CALLS, host_calls=1)
    jit_shard_report["config5 order 5 serve"] = {"bit_for_bit": ok}
    del served, m_e, m_j, step_e, step_j, low_c5, tables_c5
    torch.cuda.empty_cache()
    phase("jit sharded: config5 order 5")

    # scaling.py at order 3 on local meshes of 1, 2 and 4 ranks, eager and
    # captured in one table (the gamma4 phase's scaling lines are eager)
    roots3, para3 = g4.vertex4_roots(3)
    c3 = compile_evaluator(roots3, max_loop_num=para3.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
                           device=dev, dtype=torch.float32)
    pts = [p_ for jit in (False, True)
           for p_ in (scaling.sample_axis_points(c3, para3, (1, 2, 4), BATCH, 10, dev, jit=jit)
                      + scaling.graph_axis_points(roots3, (1, 2, 4), 1024, 10, dev, jit=jit))]
    for p_ in pts:
        print(f"jit scaling: {json.dumps(p_)}", flush=True)
    for line in scaling.table(pts).splitlines():
        print(f"jit scaling: {line}  [{smi}]", flush=True)
    jit_shard_report["scaling"] = pts
    del c3, roots3
    torch.cuda.empty_cache()
    phase("jit sharded: scaling")

    # benchmarks/probe_bucket_fusion.py at the JAX script's shapes
    fusion = probe_bucket_fusion.run(dev)
    for row in fusion["rows"]:
        print(f"probe_bucket_fusion: {json.dumps(row)}", flush=True)
    if not fusion["ok"]:
        fail("probe_bucket_fusion: the level kernel left its plain version, or a formulation "
             "left the kernel beyond its tolerance")
    torch.cuda.empty_cache()
    phase("jit sharded: probe_bucket_fusion")


    fused, bucketed = times["fused"], times["bucketed"]
    # onehot's other design, timed in turns with the kernel of record
    variant = onehot_designs[1]
    extra = {"onehot": {"variant": {
        "name": variant.__name__, "device_ms": onehot_dev[variant],
        "record_device_ms": onehot_dev[onehot_designs[0]], "max_abs_err": onehot_err[variant]}}}
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
                     "bucket_by_bucket_ms": bucketed["bucket_ms"]},
        "sharded": sharded_report,
        "hubbard": {str(order): h for order, h in hubbard.items()},
        "config4": config4, "gv_sigma6": gv_report["sigma6"],
        "gamma4": {str(order): rep for order, rep in g4_report.items()},
        "gamma4_past_2_31": g4_big,
        "jit": {"paths_captured": sorted(jit_report), "cases": jit_report},
        "jit_sharded": jit_shard_report, "probe_bucket_fusion": fusion["rows"],
        "launch_plan": plan_report, "column_runs": col_report}] + [{
            "name": f"probe_{name}", "route": "cuda",
            "source": "feynmandiagram_tpu_torch/csrc/row_probes.cu",
            "replaces": f"benchmarks/probe_mosaic_caps.py:{PROBE_LINE[name]}",
            "launches": probe_launches[name], "max_abs_err": probe_err[name],
            "ms": probe_call[name][0], "plain_ms": probe_call[name][1],
            "bound_ms": probe_bound[name][0], "bound_by": probe_bound[name][1],
            "library_ms": probe_call[name][2], "device_ms": probe_dev[name][0],
            "plain_device_ms": probe_dev[name][1], "library_device_ms": probe_dev[name][2],
            "floor_device_ms": floor_dev, **extra.get(name, {})}
            for name in PROBE_LINE]}
    # the leaf kernel, after the level kernel: the main path's launches, the
    # worst disagreement of every check, times at order-4 Gamma4
    g4t = leaf_report["times"]["gamma4 order 4"]
    report["kernels"].insert(1, {
        "name": "leaf_eval", "route": "cuda",
        "source": "feynmandiagram_tpu_torch/csrc/leaf_eval.cu",
        "replaces": "feynmandiagram_tpu/ops/leaf_eval.py:119",
        "replaces_what": "the XLA loop fusion of the leaf phase's jnp chain (no Pallas kernel)",
        "launches": leaf_main,
        "max_abs_err": max(r["max_abs_err"] for r in leaf_report["checks"].values()),
        "max_ulps": max(r["ulps"] for r in leaf_report["checks"].values()),
        "ms": g4t["ms"]["leaf_eval"], "plain_ms": g4t["ms"]["plain"],
        "bound_ms": g4t["bounds"]["ms"], "bound_by": g4t["bounds"]["by"],
        "bytes_bound_ms": g4t["bounds"]["bytes_ms"], "op_floor_ms": g4t["bounds"]["floor_ms"],
        "library_ms": None, "phase_ms": g4t["ms"]["phase"],
        "op_rates": op_ms, "checks": leaf_report["checks"],
        "times": {k: {"ms": v["ms"],
                      **{f"{b}_ms": v["bounds"][f"{b}_ms"] for b in ("bytes", "floor")}}
                  for k, v in leaf_report["times"].items()}})
    print(f"chip_smoke: the whole run took {time.perf_counter() - STARTED:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--column-runs"]:
        column_run_main()
    else:
        main()
