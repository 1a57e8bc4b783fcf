"""The port's spans and counters (``utils.profiling``) on the CPU.

- ``scope`` is the shared null context, and no manifest is recorded, when
  no profiler runs and no capture is open;
- a captured pass keeps a launch manifest: with ``test_torch_jit``'s
  stand-in for ``capture`` and the kernels' CPU paths counted as the card
  counts their launches, an order-2 Gamma4 pass and config 4's Taylor-expanded
  Sigma at order 2 hold one ``leaf`` launch, then one launch a level that
  holds buckets or plans, in level order, tagged ``gL{NN}/fb{n}`` or
  ``gL{NN}/sb{n}``; the launch counters grow by the manifest at each replay
  of ``mc.CapturedLoop.run``, ``ops.graphs.Captured`` and
  ``ops.graphs.SeededGraph``, and a replay runs in the scope
  ``replay:<name>``;
- ``phases()`` holds ``lower``, ``leaf_tables`` and ``upload`` inside
  ``compile_evaluator``, a recursive front-end call once, and a phase is a
  ``record_function`` span while a profiler runs.
"""
import glob
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu_torch import mc  # noqa: E402
from feynmandiagram_tpu_torch.backends import compile as compile_mod  # noqa: E402
from feynmandiagram_tpu_torch.benchmarks import bench_config4  # noqa: E402
from feynmandiagram_tpu_torch.ops import evaluator as evaluator_mod  # noqa: E402
from feynmandiagram_tpu_torch.ops import graphs, kernels, leaf_eval  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import level_buckets  # noqa: E402
from feynmandiagram_tpu_torch.utils import profiling  # noqa: E402

from test_torch_host import PORT, generate  # noqa: E402
from test_torch_jit import _StandIn  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
BATCH = 8
KERNELS = (leaf_eval.leaf_eval, kernels.level_gather_reduce, kernels.bucket_gather_reduce)


def _gamma4():
    roots, para = generate(PORT, "vertex4", 2)
    compiled = compile_mod.compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                                             kF=KF, lam=LAM, device="cpu",
                                             dtype=torch.float64)
    return compiled, para


def _config4():
    compiled, para, _ = bench_config4.build_config4(2, device="cpu", dtype=torch.float64)
    return compiled, para


CASES = {"gamma4-o2": _gamma4, "config4-sigma2": _config4}


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = CASES[name]()
        return cache[name]

    return get


@pytest.fixture
def captured(monkeypatch):
    """``test_torch_jit``'s stand-in capture in every module that captures,
    ``require_cuda`` passing the CPU, and the leaf and level kernels' CPU
    paths counted as launches (``profiling.launched``), as the card counts
    the kernels they stand for."""
    fake = _StandIn()
    monkeypatch.setattr(graphs, "capture", fake)
    monkeypatch.setattr(mc, "capture", fake)
    for mod in (graphs, mc, compile_mod, evaluator_mod):
        monkeypatch.setattr(mod, "require_cuda", lambda device, what: None)

    def counted(module, plain, kernel):
        run_plain = getattr(module, plain)

        def run(*args, **kwargs):
            run_plain(*args, **kwargs)
            profiling.launched(kernel)

        monkeypatch.setattr(module, plain, run)

    counted(leaf_eval, "leaf_eval_plain", leaf_eval.leaf_eval)
    counted(kernels, "level_gather_reduce_plain", kernels.level_gather_reduce)
    return fake


def _counts():
    return [k.launches for k in KERNELS]


def _grew_by(before, m, n=1):
    return [b + n * m.per_kernel.get(k, 0) for b, k in zip(before, KERNELS)] == _counts()


def _loop(compiled, para):
    return mc.CapturedLoop(compiled, n_loop=para.totalLoopNum, num_tau=para.totalTauNum,
                           batch=BATCH, n_roots=len(compiled.lowered.root_slots),
                           device="cpu", dtype=torch.float64, beta=BETA)


def test_scope_and_recorder_are_null_without_profiler_or_capture():
    assert profiling.scope("gL00") is profiling._OFF
    assert profiling._recording is None and not profiling._path
    before = kernels.level_gather_reduce.launches
    profiling.launched(kernels.level_gather_reduce)
    assert kernels.level_gather_reduce.launches == before + 1
    kernels.level_gather_reduce.launches = before
    with profiling.capturing() as m:
        assert profiling.scope("gL00") is not profiling._OFF
        with profiling.scope("gL00"), profiling.scope("fb3"):
            profiling.launched(kernels.level_gather_reduce)
        with pytest.raises(RuntimeError, match="open"):
            with profiling.capturing():
                pass
    assert kernels.level_gather_reduce.launches == before
    assert [(x.symbol, x.path) for x in m] == [("gather_reduce_kernel", "gL00/fb3")]
    assert profiling.manifest(m.name) is m and m.span == f"replay:{m.name}"
    assert profiling._recording is None and profiling.scope("x") is profiling._OFF
    profiling.replayed(m, 3)
    assert kernels.level_gather_reduce.launches == before + 3
    kernels.level_gather_reduce.launches = before
    profiling.replayed(None, 3)
    assert kernels.level_gather_reduce.launches == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_loop_keeps_a_manifest_and_counts_its_replays(built, captured, case):
    compiled, para = built(case)
    loop = _loop(compiled, para)
    m = loop.graph.manifest
    levels = [i for i, lvl in enumerate(compiled.lowered.levels) if level_buckets(lvl)]
    assert [x.symbol for x in m] == ["leaf_eval_kernel"] + ["gather_reduce_kernel"] * len(levels)
    assert m[0].path == "leaf" and m[0].kernel is leaf_eval.leaf_eval
    for x, i in zip(m[1:], levels):
        level, launch = x.path.split("/")
        assert level == f"gL{i:02d}" and launch[:2] in ("fb", "sb") and launch[2:].isdigit()
        assert x.kernel is kernels.level_gather_reduce
    assert m.per_kernel == {leaf_eval.leaf_eval: 1, kernels.level_gather_reduce: len(levels)}
    before = _counts()
    loop.run(5, 3)
    assert _grew_by(before, m, 3)


def test_captured_and_seeded_graphs_count_each_replay(built, captured):
    compiled, para = built("gamma4-o2")
    jitted = compiled.jitted()
    rng = np.random.default_rng(3)
    vk = rng.standard_normal((3, para.totalLoopNum, BATCH))
    vt = rng.random((para.totalTauNum, BATCH)) * BETA
    before = _counts()
    first = jitted(vk, vt)
    assert captured.captures == 1
    m, = captured.manifests
    assert _grew_by(before, m)          # the stand-in's capture counts nothing, its replay once
    before = _counts()
    assert torch.equal(jitted(vk, vt), first) and _grew_by(before, m)

    gen = torch.Generator()
    svk = torch.empty((3, para.totalLoopNum, BATCH), dtype=torch.float64)
    svt = torch.empty((para.totalTauNum, BATCH), dtype=torch.float64)
    body = compiled.static_pass(BATCH)

    def step():
        svk.normal_(generator=gen)
        svt.uniform_(generator=gen)
        return body(svk, svt)

    seeded = graphs.SeededGraph(step, [gen])
    before = _counts()
    out = seeded.replay([7]).clone()
    assert _grew_by(before, seeded.graph.manifest)
    before = _counts()
    assert torch.equal(seeded.replay([7]), out) and _grew_by(before, seeded.graph.manifest)


def test_a_replay_runs_in_its_graphs_scope(built, captured, tmp_path):
    compiled, para = built("gamma4-o2")
    loop = _loop(compiled, para)
    with profiling.trace(str(tmp_path)):
        loop.run(1, 2)
        compiled(*(np.random.default_rng(1).standard_normal((3, para.totalLoopNum, BATCH)),
                   np.random.default_rng(2).random((para.totalTauNum, BATCH)) * BETA))
    files = glob.glob(str(tmp_path / "trace_*.json"))
    with open(files[0]) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count(loop.graph.manifest.span) == 2 and names.count("mc.chunk") == 1
    assert names.count("call") == 1
    assert {"inputs", "buffer", "leaf", "gL00", "roots"} <= set(names)


def _phases_since(t0):
    return [p for p in profiling.phases() if p.start >= t0]


def test_phases_nest_the_lowering_and_record_a_recursion_once():
    t0 = time.perf_counter()
    _gamma4()
    new = _phases_since(t0)
    names = [p.name for p in new]
    assert names.count("vertex4") == 1 and names.count("optimize_inplace") == 1
    assert names.count("compile_evaluator") == 1
    top = [p for p in new if p.parent is None]
    assert [p.name for p in top] == ["vertex4", "optimize_inplace", "compile_evaluator"]
    build = top[-1]
    inside = [p for p in new if p.parent == "compile_evaluator"]
    assert [p.name for p in inside] == ["lower", "leaf_tables", "upload"]
    assert all(build.start <= p.start <= p.end <= build.end for p in inside)
    assert all(a.end <= b.start for a, b in zip(inside, inside[1:]))


def test_sigma_phases_nest_and_trace_as_spans(tmp_path):
    t0 = time.perf_counter()
    with profiling.trace(str(tmp_path)):
        bench_config4.config4_roots(2)
    new = _phases_since(t0)
    top = [p.name for p in new if p.parent is None]
    assert top == ["sigma", "optimize_inplace", "taylorAD", "optimize_inplace"]
    assert all(p.parent in ("sigma", None) for p in new)
    assert [p.name for p in new].count("sigma") == 1
    with open(glob.glob(str(tmp_path / "trace_*.json"))[0]) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"sigma", "optimize_inplace", "taylorAD"} <= spans


def test_phases_are_kept_bounded():
    start = profiling.phases()
    for _ in range(profiling.PHASES_KEPT + 5):
        with profiling.phase("probe"):
            pass
    kept = profiling.phases()
    assert len(kept) == profiling.PHASES_KEPT and kept[-1].name == "probe"
    assert not start or kept[0] != start[0]
