"""The port's graph evaluator against the JAX package's flat-layout
evaluator and the host interpreter, in float64.

The cases follow tests/test_lowering.py's equivalence suite (random DAGs,
constants, powers, wide products, bucket merging, Kahan) and add order-2
and order-3 Gamma4 over every sum_mode, slot reuse on and off, both
schedules, ``return_all`` and ``compensated``.  Tolerance: rtol 1e-11 with
atol 1e-12 * max|ref|, because the sums are taken in another order.
"""
import copy
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from feynmandiagram_tpu.backends.compile import leafmap_of  # noqa: E402
from feynmandiagram_tpu.computational_graph import (  # noqa: E402
    Graph, PROD, SUM, Power, constant_graph, eval_graph, optimize_inplace)
from feynmandiagram_tpu.frontends import ChargeCharge, Instant, NoHartree  # noqa: E402
from feynmandiagram_tpu.frontends.parquet import (DiagPara, Interaction,  # noqa: E402
                                                  Ver4Diag, vertex4)
from feynmandiagram_tpu.ops.evaluator import make_evaluator as jax_make_evaluator  # noqa: E402
from feynmandiagram_tpu.ops.lowering import lower  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import (check_lowered,  # noqa: E402
                                                    evaluate_graphs, make_evaluator)

from test_lowering import random_dag  # noqa: E402

F64 = torch.float64


def port_eval(lowered, vals, **kw):
    kw.setdefault("dtype", F64)
    return make_evaluator(lowered, device="cpu", **kw)(vals).numpy()


def jax_eval(lowered, vals, **kw):
    kw.setdefault("dtype", jnp.float64)
    return np.asarray(jax_make_evaluator(lowered, layout="flat", **kw)(vals))


def assert_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12 * np.abs(ref).max())


def _dag_case(seed, n_leaves=6, n_roots=3, depth=5):
    rng = random.Random(seed)
    leaves = [Graph([], properties=("leaf", i)) for i in range(n_leaves)]
    roots = [random_dag(rng, leaves, depth) for _ in range(n_roots)]
    leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
    vals = [rng.uniform(0.5, 1.5) for _ in range(n_leaves)]
    return roots, leafmap, vals


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_random_dag_matches_interpreter_and_jax(seed):
    roots, leafmap, vals = _dag_case(seed)
    expected = [eval_graph(r, leafmap, vals) for r in roots]
    got = evaluate_graphs(roots, np.asarray(vals), leafmap, device="cpu", dtype=F64)
    np.testing.assert_allclose(got[:, 0], expected, rtol=1e-10, atol=1e-9)
    low = lower(roots, leafmap)
    assert_close(port_eval(low, np.asarray(vals)), jax_eval(low, np.asarray(vals)))


def _cse_case(seed):
    """test_lowering.py's CSE canonicalization DAG: proportional duplicate
    products with shuffled operands, powers of products, wide prods."""
    rng = random.Random(seed)
    leaves = [Graph([], properties=("leaf", i)) for i in range(5)]

    def prop_dup_prod():
        ops = [rng.choice(leaves) for _ in range(rng.randint(2, 6))]
        ops = list({id(o): o for o in ops}.values())
        shuffled = list(ops)
        rng.shuffle(shuffled)
        f = rng.choice([0.5, 2.0, -3.0])
        a = Graph(ops, subgraph_factors=[f] + [1.0] * (len(ops) - 1), operator=PROD)
        b = Graph(shuffled, subgraph_factors=[1.0] * (len(shuffled) - 1) + [-f],
                  operator=PROD)
        return a, b

    terms, facs = [], []
    for _ in range(6):
        a, b = prop_dup_prod()
        terms += [a, b]
        facs += [rng.choice([1.0, 2.0]), rng.choice([1.0, -0.5])]
        if rng.random() < 0.4:
            terms.append(Graph([a], operator=Power(rng.randint(2, 3))))
            facs.append(rng.choice([1.0, 3.0]))
    terms.append(random_dag(rng, leaves, depth=4))
    facs.append(1.0)
    roots = [Graph(terms, subgraph_factors=facs, operator=SUM),
             random_dag(rng, leaves, depth=4)]
    leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
    return roots, leafmap, [rng.uniform(0.5, 1.5) for _ in range(5)]


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
@pytest.mark.parametrize("cse", [False, True])
def test_random_dag_fused_cse(seed, cse):
    roots, leafmap, vals = _cse_case(seed)
    low = lower(roots, leafmap, sum_mode="fused", cse=cse)
    expected = [eval_graph(r, leafmap, vals) for r in roots]
    got = port_eval(low, np.asarray(vals))
    np.testing.assert_allclose(got[:, 0], expected, rtol=1e-11, atol=1e-12)
    assert_close(got, jax_eval(low, np.asarray(vals)))


@pytest.mark.parametrize("seed", [5, 6])
def test_batched(seed):
    rng = random.Random(seed)
    leaves = [Graph([], properties=("leaf", i)) for i in range(4)]
    roots = [random_dag(rng, leaves, depth=4) for _ in range(2)]
    leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
    vals = np.array([[rng.uniform(0.5, 1.5) for _ in range(7)] for _ in range(4)])
    got = evaluate_graphs(roots, vals, leafmap, device="cpu", dtype=F64)
    for b in range(7):
        expected = [eval_graph(r, leafmap, list(vals[:, b])) for r in roots]
        np.testing.assert_allclose(got[:, b], expected, rtol=1e-10, atol=1e-9)


def test_constants_leaf_roots_and_powers():
    g1 = Graph([], properties="x")
    c = constant_graph(5.0)
    s = Graph([g1, c], subgraph_factors=[2.0, 3.0], operator=SUM)
    p = Graph([g1], subgraph_factors=[2.0], operator=Power(3))
    got = evaluate_graphs([s, g1, p], np.asarray([-1.5]), {g1.id: 0}, device="cpu",
                          dtype=F64)
    np.testing.assert_allclose(got[:, 0], [2 * -1.5 + 15.0, -1.5, 2.0 * (-1.5) ** 3])


def test_wide_prod_and_shared_subgraph():
    leaves = [Graph([], properties=i) for i in range(9)]
    p = Graph(leaves, subgraph_factors=[1.0 + i * 0.1 for i in range(9)], operator=PROD)
    shared = Graph([leaves[0]], subgraph_factors=[3.0], operator=Power(2))
    a = Graph([shared, leaves[1]], operator=PROD)
    b = Graph([shared, shared], subgraph_factors=[1.0, 2.0], operator=SUM)
    leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
    vals = [1.0 + 0.05 * i for i in range(9)]
    for mode in ("csr", "bucketed", "fused"):
        low = lower([p, a, b], leafmap, sum_mode=mode)
        got = port_eval(low, np.asarray(vals))
        expected = [eval_graph(r, leafmap, vals) for r in (p, a, b)]
        np.testing.assert_allclose(got[:, 0], expected, rtol=1e-12)


@pytest.mark.parametrize("seed", [1, 2, 7, 9, 11])
def test_bucketed_and_fused_match_csr(seed):
    roots, leafmap, vals = _dag_case(seed)
    vals = np.asarray(vals)
    ref = port_eval(lower(roots, leafmap, sum_mode="csr"), vals)
    for mode in ("bucketed", "fused"):
        low = lower(roots, leafmap, sum_mode=mode, max_sum_arity=4)
        assert_close(port_eval(low, vals), ref)


@pytest.mark.parametrize("threshold", [100, 10000])
def test_merged_buckets(threshold):
    roots, leafmap, vals = _dag_case(13)
    vals = np.asarray(vals)
    for mode in ("bucketed", "fused"):
        base = lower(roots, leafmap, sum_mode=mode)
        merged = lower(roots, leafmap, sum_mode=mode, merge_threshold=threshold)
        assert_close(port_eval(merged, vals), port_eval(base, vals))
        assert_close(port_eval(merged, vals), jax_eval(merged, vals))


def test_compensated_cancellation_bucket_f32():
    big = Graph([], properties=("leaf", "big"))
    small = Graph([], properties=("leaf", "small"))
    sub, fac = [], []
    for _ in range(16):
        sub.extend([big, big, small])
        fac.extend([1.0e6, -1.0e6, 1.0])
    root = Graph(sub, subgraph_factors=fac)
    low = lower([root], {big.id: 0, small.id: 1}, sum_mode="fused", max_sum_arity=64)
    vals = np.asarray([[1.0], [1.0]], np.float32)
    plain = float(port_eval(low, vals, dtype=torch.float32)[0, 0])
    kahan = float(port_eval(low, vals, dtype=torch.float32, compensated=True)[0, 0])
    jax_kahan = float(jax_eval(low, vals, dtype=jnp.float32, compensated=True)[0, 0])
    assert kahan == pytest.approx(16.0, abs=1e-3)
    assert abs(kahan - 16.0) <= abs(plain - 16.0)
    assert kahan == jax_kahan


def test_acc_dtype_widens_f32_storage():
    roots, leafmap, vals = _dag_case(3)
    low = lower(roots, leafmap, sum_mode="fused")
    vals = np.asarray(vals, np.float32)
    got = port_eval(low, vals, dtype=torch.float32, acc_dtype=F64)
    ref = jax_eval(low, vals, dtype=jnp.float32, acc_dtype=jnp.float64)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7 * np.abs(ref).max())


def test_bf16_storage_f32_acc_matches_jax():
    """tests/test_lowering.py::test_bf16_storage_f32_acc in the port: order-2
    Gamma4, bucketed, half-width bf16 buffer with float32 accumulation.  Each
    of port and JAX is held to that test's bounds against float64.  Between
    them: both round every stored level to bf16 (unit roundoff 2^-8) after
    float32 sums taken in another order, so a rounding may flip by one bf16
    ulp and carry on up the levels; they must agree within 2^-6 relative to
    the output scale, four times that ulp."""
    roots = _gamma4(2)
    low = lower(roots, leafmap_of(roots), sum_mode="bucketed")
    vals = np.random.default_rng(2).uniform(0.25, 4.0, (len(leafmap_of(roots)), 16))
    f64 = jax_eval(low, vals)
    out = make_evaluator(low, device="cpu", dtype=torch.bfloat16,
                         acc_dtype=torch.float32)(vals.astype(np.float32))
    assert out.dtype == torch.float32
    got = out.double().numpy()
    ref = np.asarray(jax_make_evaluator(low, dtype=jnp.bfloat16, acc_dtype=jnp.float32)(
        vals.astype(np.float32)), np.float64)
    denom = np.maximum(np.abs(f64), 1e-3 * np.abs(f64).max())
    for mixed in (got, ref):
        rel = np.abs(mixed - f64) / denom
        assert np.median(rel) < 1e-2, np.median(rel)
        assert rel.max() < 0.5, rel.max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6 * np.abs(ref).max())


def test_compile_evaluator_f32_storage_f64_acc_matches_jax():
    """compile_evaluator(dtype=float32, acc_dtype=float64) against the JAX
    package's, on order-2 Gamma4.  The float32 leaf phases differ in
    rounding (closed-form G tower against nested grad), so the roots agree
    to float32 storage: per root, max|diff| <= 1e-5 * max|ref|."""
    from feynmandiagram_tpu.backends import compile as jax_compile
    from feynmandiagram_tpu_torch.backends import compile_evaluator
    para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True, filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = _gamma4(2)
    rng = np.random.default_rng(7)
    varK = rng.standard_normal((3, para.totalLoopNum, 16))
    varT = rng.random((para.totalTauNum, 16)) * 0.5
    kw = dict(max_loop_num=para.totalLoopNum, beta=0.5, kF=1.919, lam=1.0)
    ref = np.asarray(jax_compile.compile_evaluator(
        roots, dtype=np.float32, acc_dtype=np.float64, layout="flat", **kw)(varK, varT))
    got = compile_evaluator(roots, device="cpu", dtype=torch.float32,
                            acc_dtype=torch.float64, **kw)(varK, varT)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert (np.abs(got.numpy() - ref) <= 1e-5 * scale).all()


# ---- order-2 and order-3 Gamma4 over every lowering option

_ROOTS = {}


def _gamma4(order):
    if order not in _ROOTS:
        para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                        filter=(NoHartree,),
                        interaction=(Interaction(ChargeCharge, Instant),))
        roots = [r["diagram"] for r in vertex4(para)]
        optimize_inplace(roots, level=1)
        _ROOTS[order] = roots
    return _ROOTS[order]


LOWERINGS = [(m, r, s) for m, r in (("csr", False), ("bucketed", False),
                                    ("fused", False), ("fused", True))
             for s in ("asap", "alap")]


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("sum_mode,reuse,schedule", LOWERINGS)
def test_gamma4_matches_jax(order, sum_mode, reuse, schedule):
    roots = _gamma4(order)
    low = lower(roots, leafmap_of(roots), sum_mode=sum_mode, cse=True,
                reuse_slots=reuse, schedule=schedule)
    nl = low.num_leaves - len(low.const_slots)
    vals = np.random.default_rng(order).uniform(0.25, 4.0, (nl, 6))
    # the whole buffer (roots, padding and recycled slots included), then
    # the roots with Kahan-compensated buckets
    assert_close(port_eval(low, vals, return_all=True),
                 jax_eval(low, vals, return_all=True))
    assert_close(port_eval(low, vals, compensated=True),
                 jax_eval(low, vals, compensated=True))


@pytest.mark.parametrize("chunk_rows", [7, 64])
def test_chunk_rows_keeps_values(chunk_rows):
    roots = _gamma4(2)
    low = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
    nl = low.num_leaves - len(low.const_slots)
    vals = np.random.default_rng(9).uniform(0.5, 1.5, (nl, 5))
    assert_close(port_eval(low, vals, chunk_rows=chunk_rows), port_eval(low, vals))


def _tampered(kind):
    roots = _gamma4(2)
    low = copy.deepcopy(lower(roots, leafmap_of(roots), sum_mode="fused", cse=True))
    fb = next(fb for lvl in low.levels for fb in lvl.fused)
    if kind == "out_of_bounds":
        fb.idx[0, 0, 0] = low.num_slots
    elif kind == "negative":
        fb.idx[0, 0, 0] = -1
    elif kind == "self_read":
        fb.idx[0, 0, 0] = fb.start
    elif kind == "rows_past_end":
        fb.start = low.num_slots - fb.count + 1
    return low


@pytest.mark.parametrize("kind", ["out_of_bounds", "negative", "self_read",
                                  "rows_past_end"])
def test_check_lowered_rejects_bad_tables(kind):
    low = _tampered(kind)
    with pytest.raises(ValueError):
        check_lowered(low)
    with pytest.raises(ValueError):
        make_evaluator(low, device="cpu", dtype=F64)


def test_check_lowered_accepts_real_lowerings():
    roots = _gamma4(2)
    for mode in ("csr", "bucketed", "fused"):
        check_lowered(lower(roots, leafmap_of(roots), sum_mode=mode, cse=True))
