"""The renormalized GV series (``frontends.gv.diagsGV_series``) on the CPU.

- Its float64 plain path (``compile_evaluator`` on the CPU) against the
  benchmark's plain reference (``portbench/reference``, built by the frozen
  front end from its own copy of the tables), root by root at total order 3:
  within ``RTOL`` of each root's largest magnitude, for the tau = 0 reason
  ``portbench/tests/test_portbench_reference.py`` gives (the port reads
  tau = 0 as -1e-10, the reference as 0^- exactly).
- The series against the same series assembled in the JAX package from its
  own ``diagsGV``, ``optimize_inplace`` and ``taylorAD``: identical lowered
  tables and leaf tables at total order 3, both sum modes.
- Each partition ``(o, v, g)`` at unit leaves against the tabulated
  counterterm file ``Sigma{o}_{v}_{g}.diag`` read on the FeynmanGraph path,
  group by group of external times, at total orders up to 4: the contract of
  FeynmanDiagram.jl's taylor.jl that ``test_counterterm_equivalence`` holds.
- The reference's series, built in a fresh process, loads nothing of either
  package and writes nothing under the checkout.
- The entry's set-up phase is top-level with the reads, ``optimize_inplace``
  and ``taylorAD`` inside it; its partition counter; the readers of
  ``gv_series_s`` and ``small_levels_ms.mc``.
"""
import collections
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu_torch import mc  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import level_buckets  # noqa: E402
from feynmandiagram_tpu_torch.utils import profiling  # noqa: E402
from portbench import bench, counting  # noqa: E402
from portbench.trace import Trace  # noqa: E402

from test_torch_host import (PORT, REF, assert_same_lowering, leaf_tables_with,  # noqa: E402
                             lower_with)
from test_torch_tracing import captured  # noqa: E402,F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "gvsigma6-ct"
RTOL = 1e-8
# partitions (o, v, g) with o >= 1 and o + v + g <= n
PARTITIONS = {1: 1, 2: 4, 3: 10, 4: 20, 5: 35, 6: 56}


@pytest.fixture(autouse=True)
def _bundled_tables(monkeypatch):
    """Both packages read their own bundled tables, whatever the
    environment says."""
    for pkg in (REF, PORT):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.frontends.gv"), "_TABLE_PATH", None)


def _cell(max_order):
    with open(os.path.join(bench.HERE, "configs", CONFIG + ".json")) as f:
        cfg = json.load(f)
    cfg["max_order"] = max_order
    return bench.Cell(name=f"{CONFIG}.test", chips=1, config=cfg, traffic={}, limits={},
                      end_to_end=[], per_layer=[])


def _series(max_order):
    from feynmandiagram_tpu_torch.frontends.gv import diagsGV_series
    return diagsGV_series("sigma", max_order)


def jax_series(max_order):
    """The series assembled in the JAX package as the entry assembles it:
    ``(roots, keys, n_loop)``."""
    gv = importlib.import_module(f"{REF}.frontends.gv")
    fe = importlib.import_module(f"{REF}.frontends")
    cg = importlib.import_module(f"{REF}.computational_graph")
    utility = importlib.import_module(f"{REF}.utility")
    parts = {}
    for o in range(1, max_order + 1):
        graphs = gv.diagsGV("sigma", o)
        cg.optimize_inplace(graphs, level=1)
        m = max_order - o
        if m == 0:
            parts[o, 0, 0] = graphs
            continue
        by_order = utility.taylorAD(graphs, [m, m],
                                    [lambda p: isinstance(p, fe.BareGreenId),
                                     lambda p: isinstance(p, fe.BareInteractionId)])
        for (g, v), coeffs in by_order.items():
            if g + v <= m:
                parts[o, v, g] = coeffs
    roots = [r for key in sorted(parts) for r in parts[key]]
    cg.optimize_inplace(roots, level=1)
    return roots, [key for key in sorted(parts) for _ in parts[key]], max_order + 1


def test_series_equals_the_plain_reference():
    cell = _cell(3)
    compiled, series, _ = bench.build_program(cell, "cpu", torch.float64, None)
    assert (series.n_loop, series.n_tau) == (4, 3)
    reference = bench.build_reference(cell, series)
    rng = np.random.default_rng(11)
    varK = torch.from_numpy(rng.standard_normal((3, series.n_loop, 96)))
    varT = torch.from_numpy(rng.random((series.n_tau, 96)) * series.beta)
    got, want = compiled(varK, varT), reference(varK, varT)
    assert got.shape == want.shape == (len(compiled.lowered.root_slots), 96)
    scale = want.abs().amax(dim=1)
    assert (scale > 0).all()
    assert ((got - want).abs().amax(dim=1) <= RTOL * scale).all()


@pytest.fixture(scope="module")
def both_series():
    return jax_series(3), _series(3)


@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
def test_series_lowers_as_the_jax_packages(both_series, sum_mode):
    (ref_roots, ref_keys, ref_loop), (roots, keys, n_loop, n_tau) = both_series
    assert keys == ref_keys and n_loop == ref_loop and n_tau == 3
    assert len(set(keys)) == PARTITIONS[3]
    low_p = lower_with(PORT, roots, sum_mode=sum_mode, cse=True)
    low_r = lower_with(REF, ref_roots, sum_mode=sum_mode, cse=True)
    assert_same_lowering(low_p, low_r)
    tab_p = leaf_tables_with(PORT, roots, low_p, n_loop)
    tab_r = leaf_tables_with(REF, ref_roots, low_r, n_loop)
    for name in ("leaf_type", "g_order", "v_order", "tau_in", "tau_out", "loop_idx",
                 "loop_basis"):
        x, y = getattr(tab_p, name), getattr(tab_r, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("max_order", [2, 3, 4])
def test_partitions_at_unit_leaves_are_the_tabulated_counterterms(max_order):
    from feynmandiagram_tpu_torch import computational_graph as cg
    from feynmandiagram_tpu_torch.frontends import gv

    roots, keys, _, _ = _series(max_order)
    got = collections.defaultdict(dict)
    for root, key in zip(roots, keys):
        got[key][tuple(root.properties.extT)] = cg.eval_graph(root)
    assert len(got) == PARTITIONS[max_order]
    for (o, v, g), values in got.items():
        graphs, _, ext_t = gv.diagsGV("sigma", o, g, v)
        want = {tuple(t): cg.eval_graph(x) for x, t in zip(graphs, ext_t)}
        assert values == pytest.approx(want), (o, v, g)
    assert any(v != 0 for values in got.values() for v in values.values())


def test_reference_series_loads_nothing_of_the_packages_and_writes_nothing(tmp_path):
    """The reference's series in a fresh process, from a copy of the
    benchmark's folder: no module of ``feynmandiagram_tpu`` or
    ``feynmandiagram_tpu_torch`` is loaded, no file of the copy changes, and
    the temporary tables are gone."""
    checkout, tmp = tmp_path / "checkout", tmp_path / "tmp"
    shutil.copytree(bench.HERE, checkout / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tmp.mkdir()

    def files():
        return {str(p.relative_to(checkout)): p.stat().st_mtime_ns
                for p in checkout.rglob("*")}

    before = files()
    code = ("import json, sys\n"
            "from portbench.reference.series import gv_sigma_series\n"
            "cfg = json.load(open('portbench/configs/gvsigma6-ct.json'))\n"
            "cfg['max_order'] = 3\n"
            "roots, n_loop, n_tau, _, _ = gv_sigma_series.roots(cfg)\n"
            "print(len(roots), n_loop, n_tau,\n"
            "      sorted(m for m in sys.modules if m.startswith('feynmandiagram_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(checkout), TMPDIR=str(tmp),
               PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=checkout, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["14", "4", "3", "[]"]
    assert files() == before and not list(tmp.iterdir())


def _phases_since(t0):
    return [p for p in profiling.phases() if p.start >= t0]


def test_series_phase_is_top_level_with_its_children():
    t0 = time.perf_counter()
    _series(3)
    new = _phases_since(t0)
    top = [p for p in new if p.parent is None]
    assert [p.name for p in top] == ["diagsGV_series"]
    inside = [p.name for p in new if p.parent == "diagsGV_series"]
    assert inside.count("diagsGV") == 3 and inside.count("optimize_inplace") == 4
    assert inside.count("taylorAD") == 2
    assert all(top[0].start <= p.start <= p.end <= top[0].end for p in new)


@pytest.mark.parametrize("max_order", [1, 2, 3, 4])
def test_partition_counter(max_order):
    before = profiling.counters().get("diagsGV_series.partitions", 0)
    _series(max_order)
    assert profiling.counters()["diagsGV_series.partitions"] == before + PARTITIONS[max_order]


@pytest.mark.parametrize("max_order", [5, 6])
def test_partition_counter_at_the_higher_orders(monkeypatch, max_order):
    """The partitions depend on ``max_order`` alone: with the order-1
    diagrams read in place of every order's (a build of seconds, not of
    minutes), the counter grows by 35 at order 5 and 56 at order 6."""
    gv_mod = importlib.import_module(f"{PORT}.frontends.gv.gv")
    read = gv_mod.diagsGV
    monkeypatch.setattr(gv_mod, "diagsGV", lambda kind, order, **kw: read(kind, 1, **kw))
    before = profiling.counters().get("diagsGV_series.partitions", 0)
    roots, keys, _, _ = _series(max_order)
    assert len(set(keys)) == PARTITIONS[max_order] == len(roots)
    assert profiling.counters()["diagsGV_series.partitions"] == before + PARTITIONS[max_order]


# -- the readers of the two new metrics ---------------------------------------

def _facts(kind, trace=None, units=0, lowered=None, batch=64):
    return bench.Facts(kind=kind, setup_s=1.0, host_build_s=1.0, window={}, batch=batch,
                       store_bytes=8, sample_bytes=8, lowered=lowered, leaf_tables=None,
                       trace=trace, trace_units=units)


def test_gv_series_s_reads_the_entrys_phase(monkeypatch):
    """A run's build through the program's file of the series: the reader
    gives the one top-level phase of the entry (the phases of this run alone,
    as a run's own process holds)."""
    read = bench.reader("gv_series_s")
    t0 = time.perf_counter()
    _, _, host_build_s = bench.build_program(_cell(2), "cpu", torch.float64, None)
    run = _phases_since(t0)
    mine = [p for p in run if p.name == "diagsGV_series"]
    assert len(mine) == 1 and mine[0].parent is None
    monkeypatch.setattr(profiling, "phases", lambda: run)
    value = read(_facts("mc"))
    assert value == mine[0].end - mine[0].start and 0 < value <= host_build_s


def test_gv_series_s_reads_nothing_without_one_such_phase(monkeypatch):
    read = bench.reader("gv_series_s")
    monkeypatch.setattr(profiling, "phases", lambda: [])
    assert read(_facts("mc")) is None
    twice = [profiling.Phase("diagsGV_series", None, 0.0, 1.0),
             profiling.Phase("diagsGV_series", None, 2.0, 3.0)]
    monkeypatch.setattr(profiling, "phases", lambda: twice)
    assert read(_facts("mc")) is None
    monkeypatch.delattr(profiling, "phases")
    assert read(_facts("mc")) is None


LEVEL = "void gather_reduce_kernel<float, float, 4, false>(float*, float const*)"
LEAF = "void (anonymous namespace)::leaf_eval_kernel<double>(Args)"


@pytest.fixture
def small_cell_loop(captured):  # noqa: F811
    """The series at total order 3 on the CPU, its captured loop (the
    stand-in capture, launches counted as on the card) and its manifest."""
    compiled, series, _ = bench.build_program(_cell(3), "cpu", torch.float64, None)
    loop = mc.CapturedLoop(compiled, n_loop=series.n_loop, num_tau=series.n_tau, batch=8,
                           n_roots=len(compiled.lowered.root_slots), device="cpu",
                           dtype=torch.float64, beta=series.beta)
    return compiled, loop


def _level_trace(manifest, n_levels, passes, us):
    """``passes`` replays of the graph: its leaf kernel, then a record of
    ``us[k]`` microseconds for each level launch ``k``."""
    ops, host, t = [], [], 0.0
    for _ in range(passes):
        host.append((manifest.span, t, t + 1e-6))
        ops.append((LEAF, t, t + 5e-6))
        t += 1e-5
        for k in range(n_levels):
            ops.append((LEVEL, t, t + us[k] * 1e-6))
            t += 1e-4
    return Trace(window_s=t, ops=ops[::-1], host=host)


def test_small_levels_ms_reads_the_small_levels_of_each_pass(small_cell_loop):
    compiled, loop = small_cell_loop
    read = bench.reader("small_levels_ms.mc")
    m = loop.graph.manifest
    low = compiled.lowered
    levels = [i for i, lvl in enumerate(low.levels) if level_buckets(lvl)]
    assert len(levels) >= 2
    # a batch at which the threshold lies between the levels' bounds
    at_one = [b["s"] for b in counting.level_bounds(low, 1, 8)]
    batch = int(1e-5 / (min(at_one) * max(at_one)) ** 0.5)
    small = [b["s"] < 1e-5 for b in counting.level_bounds(low, batch, 8)]
    assert any(small) and not all(small)
    us = [3.0 + k for k in range(len(levels))]
    trace = _level_trace(m, len(levels), 4, us)
    value = read(_facts("mc", trace, 4, low, batch))
    assert value == pytest.approx(1e-3 * sum(u for u, s in zip(us, small) if s))
    # everything small at the loop's own batch: every level's time
    assert read(_facts("mc", trace, 4, low, 8)) == pytest.approx(1e-3 * sum(us))


def test_small_levels_ms_reads_nothing_where_nothing_applies(small_cell_loop):
    compiled, loop = small_cell_loop
    read = bench.reader("small_levels_ms.mc")
    m = loop.graph.manifest
    low = compiled.lowered
    n = sum(1 for lvl in low.levels if level_buckets(lvl))
    trace = _level_trace(m, n, 3, [4.0] * n)
    assert read(_facts("mc", trace, 3, low)) is not None
    assert read(_facts("call", trace, 3, low)) is None
    assert read(_facts("mc", None, 3, low)) is None
    assert read(_facts("mc", trace, 4, low)) is None                 # a record missing
    assert read(_facts("mc", trace, 3, low, batch=10 ** 9)) is None  # no small level
    stray = Trace(trace.window_s, trace.ops, [("replay:g_no_such_graph", 0.0, 1e-6)])
    assert read(_facts("mc", stray, 3, low)) is None                 # no manifest
