"""``ProdPlan`` and ``PowerPlan`` rows inside the level launch, on the CPU.

A product of arity k (and a power of n) of arity, or exponent, 1..4 is
packed by ``ops.evaluator.level_buckets`` as a bucket of one term of k (n)
operands, and runs in the level's one ``level_gather_reduce`` launch; on
the CPU that is ``level_gather_reduce_plain``.  Held here:

- the packed plans against the JAX package's ``_eval_levels``, jitted on the
  CPU, on the same numpy leaf values in float64: bucketed Gamma4 at orders
  2-4, the Hubbard atom's lowerings at orders 1-4 and config 4 (Σ order 3,
  fused and bucketed, whose lowerings hold ``PowerPlan``s).  The whole
  weight buffer, per row rtol 1e-12 plus 1e-12 * the row's max|ref|: the
  kernel multiplies ``(w[i0] * fac) * w[i1] * ...``, the JAX package
  ``(w[i0] * w[i1] * ...) * fac`` and ``integer_pow(w, n) * fac``, which
  differ in rounding only;
- the graph-sharded bucketed pass on 4 local ranks against the unsharded
  one, bit for bit (one arithmetic), its prod groups packed too;
- a synthetic plan of arity 5 and a power of 5, which still run as the
  plain chain, unsharded and sharded;
- the launches a pass: one a level that holds buckets or plans.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from feynmandiagram_tpu.ops.evaluator import _eval_levels as jax_eval_levels  # noqa: E402
from feynmandiagram_tpu_torch.ops import evaluator as ev_mod  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import (level_buckets, make_evaluator,  # noqa: E402
                                                    plan_bucket)
from feynmandiagram_tpu_torch.ops.lowering import (LevelPlan, LoweredGraph,  # noqa: E402
                                                   PowerPlan, ProdPlan, SumBucket)
from feynmandiagram_tpu_torch.parallel import Mesh, make_graph_sharded_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.parallel import graph_shard  # noqa: E402

from test_torch_host import REF, generate, generate_taylor, lower_with  # noqa: E402

F64 = torch.float64


def _hubbard_roots(order):
    """The JAX package's Hubbard-atom Σ of ``order`` (``Interaction(UpDown,
    Instant)``), optimized, as ``models/hubbard_atom.py`` builds it."""
    from feynmandiagram_tpu.computational_graph import optimize_inplace
    from feynmandiagram_tpu.frontends import Instant, UpDown
    from feynmandiagram_tpu.frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
    para = DiagPara(type=SigmaDiag, innerLoopNum=order, hasTau=True,
                    interaction=(Interaction(UpDown, Instant),))
    ext_k = np.zeros(para.totalLoopNum)
    ext_k[0] = 1.0
    roots = [r["diagram"] for r in sigma(para, ext_k, False)]
    optimize_inplace(roots, level=1)
    return roots


CASES = ([(f"gamma4_o{o}_bucketed", partial(generate, REF, "vertex4", o), "bucketed")
          for o in (2, 3, 4)]
         + [(f"hubbard_o{o}", partial(_hubbard_roots, o), "bucketed") for o in (1, 2, 3, 4)]
         + [(f"config4_o3_{m}", partial(generate_taylor, REF, 3), m)
            for m in ("fused", "bucketed")])


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def lowered(request):
    _, make, mode = request.param
    roots = make()
    roots = roots[0] if isinstance(roots, tuple) else roots
    return request.param[0], lower_with(REF, roots, sum_mode=mode, cse=True)


def _buffer(low, batch, seed):
    """The weight buffer a pass starts from: seeded leaf values in [0.5,
    1.5), the constants in their slots, zeros elsewhere."""
    w = np.zeros((low.num_slots, batch))
    nl = low.num_leaves - len(low.const_slots)
    w[:nl] = np.random.default_rng(seed).uniform(0.5, 1.5, (nl, batch))
    w[np.asarray(low.const_slots, np.int64)] = np.asarray(low.const_values)[:, None]
    return w


def _counting(monkeypatch, module):
    calls = []
    real = module.level_gather_reduce

    def spy(w, tables, **kw):
        calls.append(tables)
        return real(w, tables, **kw)

    monkeypatch.setattr(module, "level_gather_reduce", spy)
    return calls


def test_packed_plans_match_jax_eval_levels(lowered, monkeypatch):
    name, low = lowered
    n_plans = sum(len(lvl.prods) + len(lvl.pows) for lvl in low.levels)
    if name.startswith("config4"):
        assert sum(len(lvl.pows) for lvl in low.levels) > 0
    assert n_plans > 0 or name == "config4_o3_fused"
    batch = 12
    w0 = _buffer(low, batch, 3)
    want = np.asarray(jax.jit(partial(jax_eval_levels, low))(w0))
    ev = make_evaluator(low, device="cpu", dtype=F64, return_all=True)
    assert all(not lvl.prods and not lvl.pows for lvl in ev.levels)
    calls = _counting(monkeypatch, ev_mod)
    nl = low.num_leaves - len(low.const_slots)
    got = ev(w0[:nl]).numpy()
    rule = sum(1 for lvl in low.levels if lvl.sum_buckets or lvl.fused or lvl.prods or lvl.pows)
    assert len(calls) == rule == sum(1 for lvl in low.levels if level_buckets(lvl))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12 * np.abs(r).max())


def test_plan_buckets_compute_the_plans():
    """``plan_bucket`` of a ``ProdPlan`` and a ``PowerPlan`` through the
    plain level version: the products in the kernel's order, exactly."""
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.uniform(-1.5, 1.5, (10, 6)))
    prod = ProdPlan(3, 6, 2, np.array([[0, 1], [2, 3], [4, 5]], np.int32), np.array([2.0, -0.5]))
    power = PowerPlan(4, 8, 2, np.array([1, 5], np.int32), np.array([1.5, 3.0]))
    tables = ev_mod.pack_level([plan_bucket(prod), plan_bucket(power)], "cpu", F64)
    got = w.clone()
    ev_mod.level_gather_reduce(got, tables)
    for c in range(2):
        i = prod.idx[:, c]
        assert torch.equal(got[6 + c], ((w[i[0]] * prod.factor[c]) * w[i[1]]) * w[i[2]])
        s = w[power.src[c]]
        assert torch.equal(got[8 + c], (((s * power.factor[c]) * s) * s) * s)
    assert torch.equal(got[:6], w[:6])


def _synthetic():
    """A lowering by hand: 6 leaves, one level with a ProdPlan of arity 5
    and a PowerPlan of 5 (both past the kernel's 4 operands), a ProdPlan of
    arity 2 and a PowerPlan of 2 (in the launch), then a SumBucket of the
    four."""
    idx5 = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]], np.int32)
    level0 = LevelPlan(sums=None,
                       prods=[ProdPlan(5, 6, 2, idx5, np.array([2.0, -1.0])),
                              ProdPlan(2, 8, 2, idx5[:2], np.array([0.5, 1.0]))],
                       pows=[PowerPlan(5, 10, 2, np.array([0, 3], np.int32),
                                       np.array([1.0, -2.0])),
                             PowerPlan(2, 12, 2, np.array([2, 5], np.int32),
                                       np.array([3.0, 1.0]))])
    level1 = LevelPlan(sums=None, prods=[], pows=[], sum_buckets=[SumBucket(
        arity=4, start=14, count=2, idx=np.array([[6, 7], [8, 9], [10, 11], [12, 13]], np.int32),
        fac=np.array([[1.0, 1.0], [1.0, -1.0], [0.5, 1.0], [1.0, 2.0]]))])
    return LoweredGraph(num_slots=16, num_leaves=6, levels=[level0, level1],
                        root_slots=np.array([14, 15, 6, 10], np.int32),
                        leaf_uid_to_slot={i: i for i in range(6)},
                        const_slots=np.zeros(0, np.int32), const_values=np.zeros(0),
                        num_edges=20)


def test_arity_five_runs_the_plain_chain(monkeypatch):
    low = _synthetic()
    ev = make_evaluator(low, device="cpu", dtype=F64)
    lvl0 = ev.levels[0]
    assert [p[-1] for p in lvl0.prods] == ["prod5"] and [p[-1] for p in lvl0.pows] == ["pow5"]
    assert len(lvl0.tables.desc) == 2 and lvl0.bucket_scope == "fb2"
    assert ev.levels[1].bucket_scope == "sb1"
    w0 = _buffer(low, 8, 5)
    calls = _counting(monkeypatch, ev_mod)
    got = ev(w0[:6]).numpy()
    assert len(calls) == 2
    want = np.asarray(jax.jit(partial(jax_eval_levels, low))(w0))[low.root_slots]
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_arity_five_sharded_matches_unsharded():
    low = _synthetic()
    w0 = _buffer(low, 8, 6)
    got = make_graph_sharded_evaluator(low, Mesh([("graph", 2)], device="cpu"))(w0[:6])
    want = make_evaluator(low, device="cpu", dtype=F64)(w0[:6])
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def gamma4_o3_sharded():
    roots, _ = generate(REF, "vertex4", 3)
    return lower_with(REF, roots, sum_mode="bucketed", cse=True, reuse_slots=False)


def test_sharded_bucketed_packs_the_prod_groups(gamma4_o3_sharded, monkeypatch):
    """Gamma4 order 3, bucketed, on 4 local graph ranks: every prod group
    rides the level launch, one launch a level and a rank, and the roots
    equal the unsharded evaluator's bit for bit."""
    low = gamma4_o3_sharded
    assert sum(len(lvl.prods) for lvl in low.levels) > 0
    w0 = _buffer(low, 16, 7)
    nl = low.num_leaves - len(low.const_slots)
    mesh = Mesh([("graph", 4)], device="cpu")
    g = make_graph_sharded_evaluator(low, mesh)
    plan = graph_shard._Plan(low, mesh, "graph", F64, True, None, "flat")
    for per_rank in plan.device_eval.levels:
        assert all(not r.prods and not r.pows for r in per_rank)
    calls = _counting(monkeypatch, graph_shard)
    got = g(w0[:nl])
    n_levels = sum(1 for lvl in low.levels if level_buckets(lvl))
    assert len(calls) == 4 * n_levels
    assert torch.equal(got, make_evaluator(low, device="cpu", dtype=F64)(w0[:nl]))
