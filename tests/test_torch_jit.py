"""The port's captured pass (``jit=True``) on the CPU: the body a CUDA graph
captures, run eagerly, against the eager pass and the JAX package's jitted
``compile_evaluator``.

A CUDA graph is captured and replayed only on the card (``chip_smoke.py``'s
``jit`` phase).  Here the static passes, ``Evaluator.static_pass``,
``CompiledEvaluator.static_pass`` and ``HubbardSigma.static_pass``, run
eagerly in float64: bit for bit equal to the eager pass (the same
operations on the same values), and within rtol 1e-12 plus
1e-12 * max|ref| per root of the JAX package's ``compile_evaluator(jit=True)``
jitted on the CPU (the tolerance of ``tests/test_torch_config4.py``: the two
packages' G towers differ in the last digits) on the same numpy ``varK`` /
``varT``.  A static weight buffer poisoned with NaN outside the rows that
``unwritten_reads`` says a pass needs zeroed gives the same roots.  The
replay logic of ``ops.graphs.Captured`` and ``mc.CapturedLoop`` runs with a
stand-in for ``capture`` whose replay runs the body eagerly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends import compile as jax_compile  # noqa: E402
from feynmandiagram_tpu_torch import mc  # noqa: E402
from feynmandiagram_tpu_torch.backends import compile_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.benchmarks import bench_config4  # noqa: E402
from feynmandiagram_tpu_torch.models import hubbard_atom  # noqa: E402
from feynmandiagram_tpu_torch.ops import graphs  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import (make_evaluator,  # noqa: E402
                                                     unwritten_reads)
from feynmandiagram_tpu_torch.utils import profiling  # noqa: E402

from test_torch_host import PORT, REF, generate, generate_taylor, to_port  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
BATCH = 16
HUBBARD_BETA = 2.3


def _samples(para, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, para.totalLoopNum, batch)),
            rng.random((para.totalTauNum, batch)) * BETA)


def _compile(roots, para, sum_mode):
    return compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                             lam=LAM, device="cpu", dtype=torch.float64, sum_mode=sum_mode)


@pytest.fixture(scope="module")
def gamma4():
    """Per (order, sum_mode): the port's compiled Gamma4 and its para, and
    the JAX package's jitted compile_evaluator of the same graphs (orders
    2-3) or None (order 4: the port alone)."""
    cache = {}

    def get(order, sum_mode):
        if (order, sum_mode) not in cache:
            if order < 4:
                roots, para = generate(REF, "vertex4", order)
                ref = jax_compile.compile_evaluator(
                    roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
                    dtype=np.float64, layout="flat", sum_mode=sum_mode, jit=True)
                roots = to_port(roots)
            else:
                roots, para = generate(PORT, "vertex4", order)
                ref = None
            cache[order, sum_mode] = (_compile(roots, para, sum_mode), para, ref)
        return cache[order, sum_mode]

    return get


def assert_close(got, ref):
    """Per root: |got - ref| <= 1e-12 |ref| + 1e-12 max|ref of that root|."""
    assert got.shape == ref.shape and np.isfinite(ref).all()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12 * np.abs(r).max())


def _poisoned_run(compiled, varK, varT):
    """The graph phase's static pass with every row of its weight buffer
    NaN except the rows ``unwritten_reads`` has zeroed, then the leaf phase
    into its leaf rows and ``run()``."""
    sp = compiled.graph_fn.static_pass(varK.shape[-1])
    keep = torch.zeros(sp.w.shape[0], dtype=torch.bool)
    keep[np.concatenate(unwritten_reads(compiled.lowered))] = True
    sp.w[~keep] = float("nan")
    compiled.leaf_fn(torch.as_tensor(varK), torch.as_tensor(varT), out=sp.leaves)
    return sp.run()


@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_gamma4_static_pass_equals_eager(gamma4, order, sum_mode):
    compiled, para, ref = gamma4(order, sum_mode)
    varK, varT = _samples(para, BATCH, 10 * order)
    want = compiled(varK, varT)
    body = compiled.static_pass(BATCH)
    got = body(torch.as_tensor(varK), torch.as_tensor(varT))
    assert got.dtype == torch.float64 and torch.equal(got, want)
    assert torch.equal(_poisoned_run(compiled, varK, varT), want)
    if ref is not None:
        assert_close(got.numpy(), np.asarray(ref(varK, varT)))


def test_config4_static_pass_equals_eager_and_jax():
    roots, para, _ = generate_taylor(REF, 2)
    ref = jax_compile.compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                                        kF=KF, lam=LAM, dtype=np.float64, layout="flat",
                                        jit=True)
    compiled, port_para, _ = bench_config4.build_config4(2, device="cpu", dtype=torch.float64)
    assert sum(len(lvl.pows) for lvl in compiled.lowered.levels) > 0
    varK, varT = _samples(port_para, BATCH, 7)
    want = compiled(varK, varT)
    got = compiled.static_pass(BATCH)(torch.as_tensor(varK), torch.as_tensor(varT))
    assert torch.equal(got, want)
    assert torch.equal(_poisoned_run(compiled, varK, varT), want)
    assert_close(got.numpy(), np.asarray(ref(varK, varT)))


def test_unwritten_reads_of_real_lowerings_are_empty(gamma4):
    """Padding terms read the leaf row 0 or a constant slot and padded
    bucket rows are written by the kernel: no row of these lowerings needs
    a zero, and none is read stale.  No plan takes a leaf's or a constant's
    slot either (the static pass writes the constant rows every pass all
    the same)."""
    for order in (2, 3, 4):
        for sum_mode in ("fused", "bucketed"):
            low = gamma4(order, sum_mode)[0].lowered
            zero, rezero = unwritten_reads(low)
            assert zero.size == 0 and rezero.size == 0, (order, sum_mode)
            starts = [p.start for lvl in low.levels
                      for p in list(lvl.sum_buckets) + list(lvl.fused) + list(lvl.prods)
                      + list(lvl.pows)]
            assert min(starts) >= low.num_leaves, (order, sum_mode)


def test_unwritten_reads_finds_rows_read_before_written(gamma4):
    """Two reads made stale on purpose: a term of the first level reads a
    row that only the last level writes (zeroed before every pass) and a
    row that no plan writes (zeroed once); the static pass, NaN elsewhere,
    gives the eager pass's roots twice in a row."""
    import copy
    low = copy.deepcopy(gamma4(2, "bucketed")[0].lowered)
    first = next(lvl for lvl in low.levels if lvl.sum_buckets)
    last = low.levels[-1]
    assert last is not first
    later = (list(last.sum_buckets) + list(last.prods))[0].start
    low.num_slots += 1
    never = low.num_slots - 1
    idx = first.sum_buckets[0].idx
    idx[0, 0], idx[-1, -1] = later, never
    zero, rezero = unwritten_reads(low)
    assert (list(zero), list(rezero)) == ([never], [later])
    ev = make_evaluator(low, device="cpu", dtype=torch.float64)
    vals = np.random.default_rng(3).uniform(0.5, 1.5, (ev.nl_input, BATCH))
    sp = ev.static_pass(BATCH)
    sp.w.fill_(float("nan"))
    sp.w[ev.zero_rows] = 0
    for _ in range(2):          # the second pass starts from the first's buffer
        sp.leaves.copy_(torch.as_tensor(vals))
        got = sp.run()
        assert torch.isfinite(got).all() and torch.equal(got, ev(vals))


@pytest.mark.parametrize("order", [2, 3, 4])
def test_hubbard_static_pass_equals_eager_for_two_U(order):
    hs = hubbard_atom.build_sigma_evaluator(order, HUBBARD_BETA, device="cpu",
                                            dtype=torch.float64)
    rng = np.random.default_rng(order)
    varT = torch.as_tensor(rng.random((hs.num_tau, BATCH)) * HUBBARD_BETA)
    varT[0] = 0.0
    body = hs.static_pass(BATCH)
    for u in (1.0, 0.37):
        got = body(varT, torch.tensor(u, dtype=torch.float64))
        want = hs.fn(varT, u)
        assert got.shape == (2, BATCH) and torch.equal(got, want)


class _StandIn:
    """``graphs.capture`` on the CPU: no graph; the body runs once at
    capture and at each replay, and a replay writes into the tensor that
    the capture returned, as a graph's replay does.  As ``capture`` does,
    the capture keeps the body's launch manifest (``utils.profiling.capturing``)
    as ``graph.manifest``; a replay's own run of the body counts no launch,
    as a graph's replay runs no Python (``ops.graphs.replay`` counts it from
    the manifest)."""

    def __init__(self):
        self.captures = 0
        self.manifests = []

    def __call__(self, body, generators=()):
        self.captures += 1
        with profiling.capturing() as manifest:
            out = body()

        class Graph:
            @staticmethod
            def replay():
                with profiling.capturing():
                    new = body()
                if new is not out:
                    out.copy_(new)

        graph = Graph()
        graph.manifest = manifest
        self.manifests.append(manifest)
        return graph, out


@pytest.fixture
def stand_in(monkeypatch):
    """The stand-in capture, and ``require_cuda`` passing the CPU, in every
    module that captures."""
    from feynmandiagram_tpu_torch.backends import compile as compile_mod
    from feynmandiagram_tpu_torch.ops import evaluator as evaluator_mod
    fake = _StandIn()
    monkeypatch.setattr(graphs, "capture", fake)
    monkeypatch.setattr(mc, "capture", fake)
    for mod in (graphs, mc, compile_mod, evaluator_mod):
        monkeypatch.setattr(mod, "require_cuda", lambda device, what: None)
    return fake


def test_captured_results_stay_and_batch_sizes_recapture(gamma4, stand_in):
    compiled, para, _ = gamma4(2, "fused")
    ev = compiled.graph_fn
    f = make_evaluator(compiled.lowered, device="cpu", dtype=torch.float64, jit=True)
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0.5, 1.5, (ev.nl_input, BATCH)) for _ in range(2))
    ra = f(a)
    rb = f(b)
    assert torch.equal(ra, ev(a)) and torch.equal(rb, ev(b)) and not torch.equal(ra, rb)
    assert stand_in.captures == 1
    c = rng.uniform(0.5, 1.5, (ev.nl_input, 2 * BATCH))
    assert torch.equal(f(c), ev(c)) and stand_in.captures == 2
    assert torch.equal(f(a), ra) and stand_in.captures == 3
    assert torch.equal(ra, ev(a))
    with pytest.raises(ValueError, match="leaf rows"):
        f(a[:-1])
    with pytest.raises(ValueError, match="return_all"):
        make_evaluator(compiled.lowered, device="cpu", jit=True, return_all=True)


def test_captured_compile_evaluator_equals_eager(gamma4, stand_in):
    compiled, para, _ = gamma4(3, "bucketed")
    roots = generate(PORT, "vertex4", 3)[0]
    jitted = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                               lam=LAM, device="cpu", dtype=torch.float64,
                               sum_mode="bucketed", jit=True)
    first = _samples(para, BATCH, 8)
    got = jitted(*first)
    assert torch.equal(got, jitted.graph_fn(jitted.leaf_fn(*first)))
    again = jitted(*_samples(para, BATCH, 9))
    assert not torch.equal(got, again) and torch.equal(got, jitted.graph_fn(
        jitted.leaf_fn(*first)))
    assert stand_in.captures == 1


def test_captured_hubbard_takes_each_U(stand_in):
    hs = hubbard_atom.build_sigma_evaluator(3, HUBBARD_BETA, device="cpu",
                                            dtype=torch.float64, jit=True)
    eager = hubbard_atom.build_sigma_evaluator(3, HUBBARD_BETA, device="cpu",
                                               dtype=torch.float64)
    rng = np.random.default_rng(2)
    varT = rng.random((hs.num_tau, BATCH)) * HUBBARD_BETA
    varT[0] = 0.0
    r1, r2 = hs.fn(varT, 1.0), hs.fn(varT, 0.37)
    assert torch.equal(r1, eager.fn(varT, 1.0)) and torch.equal(r2, eager.fn(varT, 0.37))
    assert not torch.equal(r1, r2) and stand_in.captures == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_mc_loop_draws_what_the_eager_loop_draws(gamma4, stand_in, dtype):
    compiled, para, _ = gamma4(2, "fused")
    kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=BATCH,
              n_roots=len(compiled.lowered.root_slots), device="cpu", dtype=dtype,
              iters=3, beta=BETA, seed=5)
    want = mc.mc_run(compiled.fn, **kw)
    got = mc.mc_run(compiled, jit=True, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="CompiledEvaluator"):
        mc.mc_run(compiled.fn, jit=True, **kw)
    sps = mc.mc_samples_per_s(compiled, jit=True, iters=2, reps=1,
                              **{k: v for k, v in kw.items() if k not in ("iters", "seed")})
    assert sps > 0


def test_jit_raises_without_cuda(gamma4):
    compiled, para, _ = gamma4(2, "fused")
    with pytest.raises(ValueError, match="CUDA"):
        make_evaluator(compiled.lowered, device="cpu", jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        compile_evaluator(generate(PORT, "vertex4", 1)[0], max_loop_num=para.totalLoopNum,
                          beta=BETA, kF=KF, lam=LAM, device="cpu", jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        mc.mc_run(compiled, n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=4,
                  n_roots=len(compiled.lowered.root_slots), device="cpu",
                  dtype=torch.float64, iters=1, beta=BETA, seed=0, jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        hubbard_atom.build_sigma_evaluator(2, HUBBARD_BETA, device="cpu", jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        hubbard_atom.sigma_mc(2, 1.0, HUBBARD_BETA, device="cpu", jit=True, chunks=1)
