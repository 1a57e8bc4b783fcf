"""The port's leaf phase against the JAX package's, in float64: the leaf
tables field by field, and the leaf values on the same numpy samples; in
float32, each leaf is the float64 value rounded once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends.compile import leaf_graphs_of, leafmap_of  # noqa: E402
from feynmandiagram_tpu.computational_graph import optimize_inplace  # noqa: E402
from feynmandiagram_tpu.frontends import (BareGreenId, BareInteractionId,  # noqa: E402
                                          ChargeCharge, Instant, NoHartree)
from feynmandiagram_tpu.frontends.parquet import (DiagPara, Interaction,  # noqa: E402
                                                  SigmaDiag, Ver4Diag, sigma, vertex4)
from feynmandiagram_tpu.ops import leaf_eval as jax_leaf  # noqa: E402
from feynmandiagram_tpu.ops.lowering import lower  # noqa: E402
from feynmandiagram_tpu.utility import taylorAD  # noqa: E402
from feynmandiagram_tpu_torch.backends.compile import (  # noqa: E402
    leaf_graphs_of as port_leaf_graphs_of)
from feynmandiagram_tpu_torch.ops.leaf_eval import (LeafTables,  # noqa: E402
                                                    leaf_tables_from_lowered,
                                                    make_leaf_evaluator)

from test_torch_host import to_port  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
FIELDS = ["leaf_type", "g_order", "v_order", "tau_in", "tau_out", "loop_idx",
          "loop_basis"]


def _vertex4(order):
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [r["diagram"] for r in vertex4(para)]
    optimize_inplace(roots, level=1)
    return roots, para.totalLoopNum, para.totalTauNum


def _sigma_series():
    """Order-2 self-energy with [2, 2] Taylor counterterms: leaves of G and
    V derivative orders 0..2."""
    para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    roots = [r["diagram"] for r in sigma(para, extK, False)]
    optimize_inplace(roots, level=1)
    dict_g = taylorAD(roots, [2, 2], [lambda p: isinstance(p, BareGreenId),
                                      lambda p: isinstance(p, BareInteractionId)])
    all_roots = [g for o in sorted(dict_g) for g in dict_g[o]]
    optimize_inplace(all_roots, level=1)
    return all_roots, para.totalLoopNum, para.totalTauNum


CASES = {"vertex4_o2": lambda: _vertex4(2), "vertex4_o3": lambda: _vertex4(3),
         "sigma2_taylor22": _sigma_series}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    roots, max_loop, n_tau = CASES[request.param]()
    lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True)
    jt = jax_leaf.leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), max_loop)
    # the port reads its own graph classes: the same graphs, ids kept
    pt = leaf_tables_from_lowered(lowered, port_leaf_graphs_of(to_port(roots)), max_loop)
    return jt, pt, max_loop, n_tau


def test_tables_equal_field_by_field(case):
    jt, pt, _, _ = case
    for name in FIELDS:
        a, b = getattr(jt, name), getattr(pt, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert pt.num_leaves == jt.num_leaves


@pytest.mark.parametrize("convention", ["lambda_power", "taylor"])
def test_leaf_values_match_jax(case, convention):
    jt, pt, max_loop, n_tau = case
    rng = np.random.default_rng(4)
    varK = rng.standard_normal((3, max_loop, 24))
    varT = rng.random((n_tau, 24)) * BETA
    expected = np.asarray(jax_leaf.make_leaf_evaluator(
        jt, beta=BETA, kF=KF, lam=LAM, dtype=np.float64,
        interaction_convention=convention)(varK, varT))
    got = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu",
                              dtype=torch.float64,
                              interaction_convention=convention)(varK, varT)
    assert got.dtype == torch.float64 and got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12,
                               atol=1e-12 * np.abs(expected).max())


def test_float32_leaves_are_float64_rounded_once(case):
    """The float32 leaf phase computes in float64 and rounds each leaf once
    (the JAX package computes in float32): bit for bit the float64 values
    cast to float32, and within half an ulp of the JAX package's float64
    leaves."""
    jt, pt, max_loop, n_tau = case
    rng = np.random.default_rng(6)
    varK = rng.standard_normal((3, max_loop, 64))
    varT = rng.random((n_tau, 64)) * BETA
    kw = dict(beta=BETA, kF=KF, lam=LAM, device="cpu")
    got = make_leaf_evaluator(pt, dtype=torch.float32, **kw)(varK, varT)
    f64 = make_leaf_evaluator(pt, dtype=torch.float64, **kw)(varK, varT)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), f64.float().numpy())
    ref = np.asarray(jax_leaf.make_leaf_evaluator(
        jt, beta=BETA, kF=KF, lam=LAM, dtype=np.float64)(varK, varT))
    assert (np.abs(got.numpy().astype(np.float64) - ref)
            <= 2.0 ** -24 * (1 + 1e-9) * np.abs(ref)).all()


def test_from_arrays_takes_jax_tables(case):
    jt, pt, max_loop, n_tau = case
    tables = LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS})
    rng = np.random.default_rng(5)
    varK = rng.standard_normal((3, max_loop, 8))
    varT = rng.random((n_tau, 8)) * BETA
    kw = dict(beta=BETA, kF=KF, lam=LAM, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(make_leaf_evaluator(tables, **kw)(varK, varT).numpy(),
                                  make_leaf_evaluator(pt, **kw)(varK, varT).numpy())


def test_from_arrays_rejects_missing_field():
    with pytest.raises(ValueError):
        LeafTables.from_arrays(leaf_type=np.zeros(2, np.int32))
