"""Per-phase time of the Monte-Carlo pass, from one ``torch.profiler`` trace.

Port of ``benchmarks/profile_pass.py``.  Runs the main path's configuration
(order-4 Gamma4, fused lowering, float32 on the card, the sampling and the
sum over the batch of ``mc.mc_run``), or with ``--config4`` config 4 (the
order-N self-energy's counterterm series, ``benchmarks/bench_config4.py``,
whose leaf phase holds the G and V derivative towers of orders 1-2), under
``utils.profiling.trace`` and
aggregates the trace by pipeline phase, through the profiler scopes that the
port's hot path enters while a profiler runs (the JAX package's
``jax.named_scope`` names):

- prng      : the sampling of varK and varT (``mc.py``)
- loops     : LoopPool product + |q|^2 (``ops/leaf_eval.py``)
- leaf      : the physics, one scope per (type, derivative order) group,
              ``leafG{o}`` / ``leafV{o}``
- graph     : the levels ``gL{NN}`` (``ops/evaluator.py``); inside a level
              ``csr``, ``fb{n}`` / ``sb{n}`` (the level's one launch of the
              gather-reduce kernel over its n buckets), ``prod{a}``, ``pow{n}``
- accum     : the sum of the roots over the batch
- other     : what ran outside every scope

Two times for each phase.  *Op time* is the device time of the kernels,
copies and fills that the phase launched, each attributed through the
profiler's correlation id to the host call that launched it; on the CPU,
where there is no device, it is the time of the phase's outermost ATen ops.
*Host time* is the time the host spent inside the phase's scopes.  With
``--levels`` both are also given by level and launch, and the leaf phase's
host time by (type, order) group is printed in any case.

The last line of the output is one JSON object with the same numbers.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.profile_pass [order] [batch] [iters]
           [--levels] [--config4] [--device cpu]
"""
from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import re
import tempfile
import time
from collections import defaultdict

BETA, KF, LAM = 0.5, 1.919, 1.0
PHASES = ("prng", "loops", "leaf", "graph", "accum", "other")
PHASE_RES = [
    ("prng", re.compile(r"/prng/")),
    ("loops", re.compile(r"/loops/")),
    ("leaf", re.compile(r"/leaf[GV]\d+/")),
    ("graph", re.compile(r"/gL\d+/")),
    ("accum", re.compile(r"/accum/")),
]
LEVEL_RE = re.compile(r"/(gL\d+)/(?:([a-z]+[\dx]*)/)?")
LEAF_RE = re.compile(r"/(leaf[GV]\d+)/")
TOP_RE = re.compile(r"^(prng|loops|leaf[GV]\d+|gL\d+|accum)$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def build_pass(order: int, batch: int, iters: int, device, config4: bool = False):
    """``(run, compiled)``: ``run(seed)`` is ``iters`` Monte-Carlo passes of
    order-``order`` Gamma4 (config 4 of order ``order`` with ``config4``)
    compiled fused on ``device`` (float32 on the card, float64 on the CPU),
    the roots' sums returned."""
    import torch

    from ..mc import mc_run
    from ..ops.dtypes import default_dtype

    device = torch.device(device)
    dtype = default_dtype(device)
    if config4:
        from .bench_config4 import build_config4
        compiled, para, _ = build_config4(order, device=device, dtype=dtype)
    else:
        from ..backends.compile import compile_evaluator
        from ..computational_graph import optimize_inplace
        from ..frontends import ChargeCharge, Instant, NoHartree
        from ..frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4
        para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True, filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [row["diagram"] for row in vertex4(para)]
        optimize_inplace(roots, level=1)
        compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                     lam=LAM, device=device, dtype=dtype, sum_mode="fused")
    kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=batch,
              n_roots=len(compiled.lowered.root_slots), device=device, dtype=dtype,
              iters=iters, beta=BETA)

    def run(seed: int):
        return mc_run(compiled.fn, seed=seed, **kw)

    return run, compiled


def _scope_paths(events):
    """Per host thread, its scopes ``(start, end, name)`` sorted by start,
    and a function that gives the scope path ``/a/b/`` enclosing a host
    timestamp on a thread."""
    by_thread = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by_thread[e["pid"], e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {}
    for key, spans in by_thread.items():
        spans.sort()
        starts[key] = [s[0] for s in spans]

    def path(thread, ts):
        spans = by_thread.get(thread, ())
        hi = bisect.bisect_right(starts.get(thread, ()), ts)
        names = [name for start, end, name in spans[:hi] if ts <= end]
        return "/" + "/".join(names) + "/" if names else "/"

    return by_thread, path


def aggregate(trace_file: str, iters: int, on_device: bool):
    """Phase, level and leaf-group tables of one trace, per pass."""
    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    by_thread, path = _scope_paths(events)
    launches = {}
    if on_device:
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ((e["pid"], e["tid"]), e["ts"])
        ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    else:
        # the outermost ATen ops of each host thread
        ops, end = [], {}
        for e in sorted((e for e in events if e.get("ph") == "X"
                         and e.get("cat") == "cpu_op"), key=lambda e: e["ts"]):
            key = (e["pid"], e["tid"])
            if e["ts"] >= end.get(key, -1.0):
                ops.append(e)
                end[key] = e["ts"] + e["dur"]

    phase_op = defaultdict(lambda: [0.0, 0])     # op us, op count
    level_op = defaultdict(lambda: [0.0, 0])
    unattributed, kernels = 0, defaultdict(int)
    for e in ops:
        if on_device:
            src = launches.get(e.get("args", {}).get("correlation"))
            if src is None:
                unattributed += 1
            p = path(*src) if src else "/"
            kernels[e["name"], p.split("/")[1] if p != "/" else ""] += 1
        else:
            p = path((e["pid"], e["tid"]), e["ts"])
        phase = next((name for name, rx in PHASE_RES if rx.search(p)), "other")
        phase_op[phase][0] += e["dur"]
        phase_op[phase][1] += 1
        m = LEVEL_RE.search(p) or LEAF_RE.search(p)
        if m:
            key = "/".join(g for g in m.groups() if g)
            level_op[key][0] += e["dur"]
            level_op[key][1] += 1

    phase_host, level_host, leaf_host = defaultdict(float), defaultdict(float), defaultdict(float)
    for spans in by_thread.values():
        stack = []   # enclosing (end, name)
        for start, end, name in spans:
            while stack and stack[-1][0] < start:
                stack.pop()
            if not stack and TOP_RE.match(name):
                phase = next(ph for ph, rx in PHASE_RES if rx.search(f"/{name}/"))
                phase_host[phase] += end - start
                if phase == "leaf":
                    leaf_host[name] += end - start
            key = "/".join([s[1] for s in stack[-1:]] + [name])
            if LEVEL_RE.search(f"/{key}/") or LEAF_RE.search(f"/{name}/"):
                level_host[key if stack else name] += end - start
            stack.append((end, name))

    def per_pass(d):
        return {k: (v / iters if not isinstance(v, list) else [v[0] / iters, v[1] / iters])
                for k, v in d.items()}

    return {"phase_op": per_pass(phase_op), "phase_host": per_pass(phase_host),
            "level_op": per_pass(level_op), "level_host": per_pass(level_host),
            "leaf_host": per_pass(leaf_host), "unattributed_ops": unattributed / iters,
            "level_kernels_in_graph": sum(
                n for (name, top), n in kernels.items()
                if "gather_reduce_kernel" in name and top.startswith("gL")) / iters}


def profile(order: int = 4, batch: int = 4096, iters: int = 20, device=None,
            config4: bool = False) -> dict:
    """Build, warm up, time one untraced run and trace one run of ``iters``
    passes; return the aggregate (``aggregate``) with the configuration,
    the untraced and traced wall per pass and the card's name."""
    import torch

    from ..ops.dtypes import default_device
    from ..utils.profiling import trace

    device = torch.device(device) if device is not None else default_device()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    run, compiled = build_pass(order, batch, iters, device, config4)
    run(0)
    sync()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(1)
    sync()
    wall = time.perf_counter() - t0
    log_dir = tempfile.mkdtemp(prefix="fdtpu_prof_")
    with trace(log_dir):
        t0 = time.perf_counter()
        run(2)
        sync()
        traced = time.perf_counter() - t0
    trace_file = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")))[-1]
    out = aggregate(trace_file, iters, device.type == "cuda")
    low = compiled.lowered
    card = None
    if device.type == "cuda":
        from . import card_name
        card = card_name()
    out.update({"workload": "config4" if config4 else "gamma4", "order": order,
                "batch": batch, "iters": iters, "device": str(device),
                "card": card, "slots": low.num_slots, "edges": low.num_edges,
                "levels": len(low.levels), "setup_s": setup,
                "wall_ms_per_pass": 1e3 * wall / iters,
                "traced_wall_ms_per_pass": 1e3 * traced / iters, "trace_file": trace_file})
    return out


def print_tables(r: dict, show_levels: bool) -> None:
    op_total = sum(v[0] for v in r["phase_op"].values())
    clock = "device" if r["card"] else "CPU op"
    print(f"# {r['workload']} order={r['order']} batch={r['batch']} iters={r['iters']} "
          f"slots={r['slots']} "
          f"edges={r['edges']} levels={r['levels']} on {r['device']}"
          + (f" [{r['card']}]" if r["card"] else ""))
    print(f"# wall (untraced) {r['wall_ms_per_pass']:.4f} ms a pass "
          f"({r['batch'] * 1e3 / r['wall_ms_per_pass']:.0f} samples/s), traced "
          f"{r['traced_wall_ms_per_pass']:.4f} ms; {clock} time {op_total / 1e3:.4f} ms a pass; "
          f"ops without a launching call {r['unattributed_ops']:.1f} a pass")
    print(f"{'phase':<8} {'op us/pass':>11} {'%':>6} {'ops/pass':>9} {'host us/pass':>13}")
    host_total = r["traced_wall_ms_per_pass"] * 1e3
    for name in PHASES:
        t, n = r["phase_op"].get(name, [0.0, 0.0])
        host = (r["phase_host"].get(name, 0.0) if name != "other"
                else host_total - sum(r["phase_host"].values()))
        print(f"{name:<8} {t:>11.1f} {100 * t / op_total if op_total else 0:>5.1f}% "
              f"{n:>9.1f} {host:>13.1f}")
    print("\n# leaf phase, host us/pass by (type, order) group: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(r["leaf_host"].items())))
    if show_levels:
        print("\n# per level/launch: op us/pass, ops/pass, host us/pass")
        for k in sorted(set(r["level_op"]) | set(r["level_host"])):
            t, n = r["level_op"].get(k, [0.0, 0.0])
            print(f"{k:<24} {t:>9.1f} {n:>7.1f} {r['level_host'].get(k, 0.0):>9.1f}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("order", nargs="?", type=int, default=4)
    parser.add_argument("batch", nargs="?", type=int, default=4096)
    parser.add_argument("iters", nargs="?", type=int, default=20)
    parser.add_argument("--levels", action="store_true", help="the table by level and launch")
    parser.add_argument("--config4", action="store_true",
                        help="config 4 (bench_config4) of the order instead of Gamma4")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    r = profile(args.order, args.batch, args.iters, args.device, args.config4)
    print_tables(r, args.levels)
    print(json.dumps({"profile_pass": r}))


if __name__ == "__main__":
    main()
