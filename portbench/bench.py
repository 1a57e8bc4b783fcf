"""One run of one cell: set-up, the measured window, the traced passes, the
comparison with the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<name>.json``, whose ``series`` names
``program/<series>.py`` and ``reference/series/<series>.py``) and its
traffic (``traffic/<name>.json``, whose ``generator`` names
``generators/<generator>.py``); ``checks/<cell>.json`` holds the limit of each
number compared; each metric the cell reports has its reader
``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "feynmandiagram_tpu")


@dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and its files give it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; ``KeyError`` if
    there is none."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = os.path.join(root, bench["paths"][0])
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(os.path.join(root, config["file"])),
                traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                limits=_json(os.path.join(here, "checks", name + ".json")),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, root: str = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Series:
    """A configuration's physics, and the sizes its roots were built at."""
    beta: float
    kF: float
    lam: float
    convention: str
    n_loop: int = 0
    n_tau: int = 0

    @classmethod
    def of(cls, cfg: dict) -> "Series":
        return cls(cfg["beta"], cfg["kF"], cfg["lam"], cfg["interaction_convention"])


@dataclass
class Facts:
    """What a run leaves for the metric readers."""
    kind: str
    setup_s: float
    host_build_s: float
    window: dict
    batch: int
    store_bytes: int
    sample_bytes: int
    lowered: object
    leaf_tables: object
    trace: Optional[object] = None
    trace_units: int = 0


def forbidden_modules() -> List[str]:
    """The top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_program(cell: Cell, device, dtype, acc_dtype):
    """The program's compiled evaluator of the cell's configuration, its
    ``Series`` and the host build's seconds."""
    from feynmandiagram_tpu_torch.backends.compile import compile_evaluator

    cfg = cell.config
    series = Series.of(cfg)
    t0 = time.perf_counter()
    roots, series.n_loop, series.n_tau = importlib.import_module(
        f"portbench.program.{cfg['series']}").roots(cfg)
    compiled = compile_evaluator(roots, max_loop_num=series.n_loop, beta=series.beta,
                                 kF=series.kF, lam=series.lam, device=device, dtype=dtype,
                                 acc_dtype=acc_dtype,
                                 interaction_convention=series.convention,
                                 sum_mode=cfg["sum_mode"])
    return compiled, series, time.perf_counter() - t0


def build_reference(cell: Cell, series: Series):
    """The plain reference of the cell's configuration: a function of
    ``(varK, varT)`` that returns the roots in float64."""
    from portbench.reference import evaluate

    cfg = cell.config
    roots, n_loop, n_tau, green, inter = importlib.import_module(
        f"portbench.reference.series.{cfg['series']}").roots(cfg)
    if (n_loop, n_tau) != (series.n_loop, series.n_tau):
        raise RuntimeError(f"the reference's series has {n_loop} loops and {n_tau} times, "
                           f"the program's {series.n_loop} and {series.n_tau}")
    plan = evaluate.plan_of(roots, n_loop, green, inter)
    return lambda varK, varT: evaluate.evaluate(plan, varK, varT, beta=series.beta,
                                                kF=series.kF, lam=series.lam,
                                                convention=series.convention)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        dtype: Optional[str] = None, acc_dtype: Optional[str] = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's fields.
    ``dtype`` and ``acc_dtype`` replace the configuration's (the control
    runs the program's lower-precision path so)."""
    import torch

    dtype = getattr(torch, dtype or cell.config["dtype"])
    acc = acc_dtype or cell.config.get("acc_dtype")
    acc = getattr(torch, acc) if acc else None
    on_card = torch.device(device).type == "cuda"
    compiled, series, host_build_s = build_program(cell, device, dtype, acc)
    generator = importlib.import_module(f"portbench.generators.{cell.traffic['generator']}")
    traffic = generator.Traffic(compiled, series, cell.traffic, seed, device, dtype)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    window = traffic.window(seconds)
    traced, units = None, 0
    if trace:
        from portbench import trace as tracing
        work, units = traffic.trace_work()
        traced = tracing.traced(work)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
    facts = Facts(kind=traffic.name, setup_s=setup_s, host_build_s=host_build_s,
                  window=window, batch=int(cell.traffic["batch"]),
                  store_bytes=torch.empty((), dtype=dtype).element_size(),
                  sample_bytes=traffic.sample_bytes, lowered=compiled.lowered,
                  leaf_tables=compiled.tables, trace=traced, trace_units=units)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(facts)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the program's state goes before the reference runs
    traffic.release()
    del compiled
    if on_card:
        torch.cuda.empty_cache()
    readings = traffic.check(build_reference(cell, series))
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    result = {"correct": failed == 0, "attempted": window["attempted"], "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def main(args, t_start: float) -> int:
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import feynmandiagram_tpu_torch  # noqa: F401  (the program under test)

    result = run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                 device=torch.device("cuda", 0), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
