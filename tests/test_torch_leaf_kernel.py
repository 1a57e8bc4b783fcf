"""The leaf phase's plain path (the CPU side of ``csrc/leaf_eval.cu``)
against the JAX package's ``make_leaf_evaluator``, on the CPU.

Both get the same leaf tables (the JAX package's, handed to the port with
``LeafTables.from_arrays``; ``tests/test_torch_host.py`` holds the two
packages' tables identical) and the same numpy-seeded ``varK`` / ``varT``.
Cases: order-4 Gamma4 (920 leaf rows), config 4's counterterm towers (G and
V at derivative orders 0-2, both interaction conventions), GV sigma at
order 3, the Hubbard atom's tables and a table with a row of no group.

Tolerance in float64: rtol 1e-12 plus 1e-12 * max|ref| per (type, order)
group, the repo's bound for the G tower (the JAX package differentiates
with nested ``jax.grad``, the port uses the closed form; the loop sum runs
over ``l`` in order here, in the einsum's order there).  The
``compute_dtype=float32`` control against the JAX package's float32 path:
both compute in float32, in different orders, so a propagator's exponent
``-eps*tau`` differs by ~``|eps*tau|`` float32 ulps between them; held at
rtol 1e-5 plus 1e-5 * max|ref| per group (SLICE_TOL).  The kernel's own
checks (bit for bit with this plain path on the card) are in
``chip_smoke.py``; its work list is held on the CPU by
``tests/test_torch_leaf_worklist.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends.compile import leaf_graphs_of  # noqa: E402
from feynmandiagram_tpu.ops import leaf_eval as jax_leaf  # noqa: E402
from feynmandiagram_tpu_torch.models.free_fermion import (  # noqa: E402
    _softplus_derivs, green_derive_tower, green_eps_part, green_tau_parts)
from feynmandiagram_tpu_torch.models.yukawa import interaction_derive  # noqa: E402
from feynmandiagram_tpu_torch.ops import leaf_eval  # noqa: E402
from feynmandiagram_tpu_torch.ops.leaf_eval import LeafTables, make_leaf_evaluator  # noqa: E402

from test_torch_host import REF, generate, generate_taylor, lower_with  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
FIELDS = ["leaf_type", "g_order", "v_order", "tau_in", "tau_out", "loop_idx", "loop_basis"]


def _jax_tables(roots, max_loop, sum_mode="fused"):
    low = lower_with(REF, roots, sum_mode=sum_mode, cse=True)
    return jax_leaf.leaf_tables_from_lowered(low, leaf_graphs_of(roots), max_loop)


def _gamma4():
    roots, para = generate(REF, "vertex4", 4)
    return _jax_tables(roots, para.totalLoopNum), para.totalTauNum


def _config4():
    roots, para, _ = generate_taylor(REF, 2)
    return _jax_tables(roots, para.totalLoopNum), para.totalTauNum


def _gv_sigma():
    import feynmandiagram_tpu.frontends.gv as gv
    from feynmandiagram_tpu.computational_graph import optimize_inplace
    roots = list(gv.diagsGV("sigma", 3))
    ids = [leaf.properties for leaf in leaf_graphs_of(roots).values()]
    max_loop, num_tau = max(len(p.extK) for p in ids), max(max(p.extT) for p in ids)
    optimize_inplace(roots, level=1)
    return _jax_tables(roots, max_loop), num_tau


def _hubbard():
    from feynmandiagram_tpu_torch.models.hubbard_atom import lower_sigma
    para, _, tables, _ = lower_sigma(3)
    return jax_leaf.LeafTables(**{n: getattr(tables, n) for n in FIELDS}), para.totalTauNum


def _no_group():
    """Six leaves: G of orders 0 and 1, V of orders 0 and 2, and two rows
    of a leaf type that no group takes (they hold 1)."""
    return jax_leaf.LeafTables(
        leaf_type=np.array([1, 0, 2, 1, 3, 2], np.int32),
        g_order=np.array([0, 0, 0, 1, 0, 0], np.int32),
        v_order=np.array([0, 0, 0, 0, 0, 2], np.int32),
        tau_in=np.array([1, 1, 1, 2, 1, 1], np.int32),
        tau_out=np.array([2, 1, 1, 1, 1, 1], np.int32),
        loop_idx=np.array([0, 0, 1, 1, 0, 0], np.int32),
        loop_basis=np.array([[1.0, 0.0], [1.0, -1.0]])), 2


CASES = {"gamma4_o4": _gamma4, "config4_o2": _config4, "gv_sigma3": _gv_sigma,
         "hubbard_o3": _hubbard, "no_group": _no_group}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jt, n_tau = CASES[request.param]()
    pt = LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS})
    return request.param, jt, pt, n_tau


def _samples(pt, n_tau, batch, seed):
    rng = np.random.default_rng(seed)
    varK = rng.standard_normal((3, pt.loop_basis.shape[1], batch))
    varT = rng.random((n_tau, batch)) * BETA
    varT[:, :4] = varT[0, :4]     # equal times: tau = 0 read as 0^-
    return varK, varT


def _assert_groups_close(pt, got, ref, rtol):
    """Per (type, order) group: |got - ref| <= rtol |ref| + rtol max|ref|."""
    assert got.shape == ref.shape and np.isfinite(got).all()
    keys = np.stack([pt.leaf_type, np.where(pt.leaf_type == 1, pt.g_order, pt.v_order)], 1)
    for key in np.unique(keys, axis=0):
        rows = (keys == key).all(axis=1)
        np.testing.assert_allclose(got[rows], ref[rows], rtol=rtol,
                                   atol=rtol * np.abs(ref[rows]).max(), err_msg=str(key))


@pytest.mark.parametrize("convention", ["lambda_power", "taylor"])
def test_plain_leaf_path_matches_jax_float64(case, convention):
    name, jt, pt, n_tau = case
    varK, varT = _samples(pt, n_tau, 40, 11)
    ref = np.asarray(jax_leaf.make_leaf_evaluator(
        jt, beta=BETA, kF=KF, lam=LAM, dtype=np.float64,
        interaction_convention=convention)(varK, varT))
    got = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu", dtype=torch.float64,
                              interaction_convention=convention)(varK, varT)
    assert got.dtype == torch.float64
    _assert_groups_close(pt, got.numpy(), ref, 1e-12)
    if name == "gamma4_o4":
        assert pt.num_leaves == 920 and (pt.leaf_type == 1).sum() == 768
    if name == "config4_o2":
        assert set(pt.g_order[pt.leaf_type == 1]) == set(pt.v_order[pt.leaf_type == 2]) \
            == {0, 1, 2}
    if name == "no_group":
        np.testing.assert_array_equal(got.numpy()[[1, 4]], 1.0)


def test_float32_compute_matches_jax_float32(case):
    """The control of chip_smoke's gamma4 phase: leaves computed in float32
    arithmetic, against the JAX package's float32 leaf phase."""
    _, jt, pt, n_tau = case
    varK, varT = _samples(pt, n_tau, 40, 12)
    ref = np.asarray(jax_leaf.make_leaf_evaluator(jt, beta=BETA, kF=KF, lam=LAM,
                                                  dtype=np.float32)(varK, varT))
    got = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu", dtype=torch.float32,
                              compute_dtype=torch.float32)(varK, varT)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    _assert_groups_close(pt, got.numpy().astype(np.float64), ref.astype(np.float64), 1e-5)


def test_plain_path_equals_the_model_functions(case):
    """The plain path's per-group arithmetic against the models' functions
    (``green_derive_tower``, ``interaction_derive``) on the scratch table's
    own eps, tau and q2: the old per-group chain, as a second reference."""
    _, _, pt, n_tau = case
    varK, varT = _samples(pt, n_tau, 24, 13)
    for convention in ("lambda_power", "taylor"):
        f = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu", dtype=torch.float64,
                                interaction_convention=convention)
        plan = f.plan
        vk = torch.as_tensor(varK)
        vt = torch.as_tensor(varT)
        scratch = torch.empty((plan.scratch_rows(), 24), dtype=torch.float64)
        leaf_eval.leaf_prep_plain(plan, vk, vt, scratch)
        got = f(varK, varT)
        nb, npair = plan.n_basis, plan.n_pairs
        for kind, order, rows, brow, pair in plan.groups:
            if kind == leaf_eval.KIND_ONE:
                want = torch.ones_like(got[rows])
            elif kind in (leaf_eval.KIND_G0, leaf_eval.KIND_G_TOWER):
                want = green_derive_tower(scratch[3 * nb + 2 * npair + pair],
                                          scratch[nb + brow], BETA, order)
            else:
                want = interaction_derive(scratch[brow], LAM, order, convention=convention)
            np.testing.assert_allclose(got[rows].numpy(), want.numpy(), rtol=1e-13,
                                       atol=1e-13 * want.abs().max().item())


def test_scratch_table_against_its_definition(case):
    """The scratch table of the plain leaf_prep: q2 = |basis @ varK|^2 and
    eps = q2 - kF^2 to 1e-13 of the einsum's sums; sp, sign and tau1 of
    those eps and taus as the model's factors of G give them
    (``green_eps_part``, ``green_tau_parts``), and tau cut as they cut it."""
    _, _, pt, n_tau = case
    varK, varT = _samples(pt, n_tau, 16, 14)
    plan = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu").plan
    scratch = torch.empty((plan.scratch_rows(), 16), dtype=torch.float64)
    leaf_eval.leaf_prep_plain(plan, torch.as_tensor(varK), torch.as_tensor(varT), scratch)
    nb, npair = plan.n_basis, plan.n_pairs
    q2 = (np.einsum("nl,dlb->dnb", pt.loop_basis, varK) ** 2).sum(axis=0)
    np.testing.assert_allclose(scratch[:nb].numpy(), q2, rtol=1e-13, atol=1e-13 * q2.max())
    if npair:
        eps = q2 - KF ** 2
        np.testing.assert_allclose(scratch[nb:2 * nb].numpy(), eps, rtol=1e-13,
                                   atol=1e-13 * np.abs(eps).max())
        np.testing.assert_allclose(scratch[2 * nb:3 * nb],
                                   green_eps_part(scratch[nb:2 * nb], BETA), rtol=1e-15)
        tau = torch.as_tensor(varT[plan.pair_out.numpy()] - varT[plan.pair_in.numpy()])
        sign, tau1 = green_tau_parts(tau, BETA)
        np.testing.assert_array_equal(scratch[3 * nb:3 * nb + npair], sign)
        np.testing.assert_array_equal(scratch[3 * nb + npair:3 * nb + 2 * npair], tau1)
        np.testing.assert_array_equal(scratch[3 * nb + 2 * npair:].numpy(),
                                      np.where(np.abs(tau) < 1e-10, -1e-10, tau))


def test_storage_types_round_once():
    """float32 and bfloat16 storage hold the float64 values rounded once
    (bfloat16 through float32, as PyTorch converts); float32 compute stored
    in float64 is the float32 value widened."""
    jt, n_tau = _config4()
    pt = LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS})
    varK, varT = _samples(pt, n_tau, 32, 15)
    kw = dict(beta=BETA, kF=KF, lam=LAM, device="cpu")
    f64 = make_leaf_evaluator(pt, dtype=torch.float64, **kw)(varK, varT)
    for dtype in (torch.float32, torch.bfloat16):
        got = make_leaf_evaluator(pt, dtype=dtype, **kw)(varK, varT)
        assert got.dtype == dtype and torch.equal(got, f64.to(dtype))
    c32 = make_leaf_evaluator(pt, dtype=torch.float32, compute_dtype=torch.float32, **kw)
    w64 = make_leaf_evaluator(pt, dtype=torch.float64, compute_dtype=torch.float32, **kw)
    assert torch.equal(w64(varK, varT), c32(varK, varT).double())


def test_writes_every_row_of_a_given_out():
    """``out=`` (a static buffer's leaf rows) is written row for row, NaN
    poison and all, and returned; a wrong shape or type raises."""
    jt, n_tau = _no_group()
    pt = LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS})
    varK, varT = _samples(pt, n_tau, 8, 16)
    f = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu", dtype=torch.float32)
    w = torch.full((9, 8), float("nan"))
    got = f(varK, varT, out=w[:6])
    assert got.data_ptr() == w.data_ptr() and torch.isfinite(w[:6]).all()
    assert torch.isnan(w[6:]).all() and torch.equal(got, f(varK, varT))
    with pytest.raises(ValueError):
        f(varK, varT, out=torch.empty((6, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        f(varK, varT, out=torch.empty((6, 7)))


def test_wrappers_run_plain_on_the_cpu_and_count_no_launch():
    jt, n_tau = _no_group()
    pt = LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS})
    varK, varT = _samples(pt, n_tau, 8, 17)
    before = leaf_eval.leaf_eval.launches
    make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu")(varK, varT)
    assert leaf_eval.leaf_eval.launches == before
    plan = make_leaf_evaluator(pt, beta=BETA, kF=KF, lam=LAM, device="cpu").plan
    meta = torch.empty((plan.num_leaves, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        leaf_eval.leaf_eval(plan, torch.as_tensor(varK), torch.as_tensor(varT), meta)


def test_tables_and_options_are_checked():
    jt, _ = _no_group()
    fields = {n: getattr(jt, n) for n in FIELDS}
    kw = dict(beta=BETA, kF=KF, lam=LAM, device="cpu")
    pt = LeafTables.from_arrays(**fields)
    with pytest.raises(ValueError, match="convention"):
        make_leaf_evaluator(pt, interaction_convention="other", **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_leaf_evaluator(pt, compute_dtype=torch.bfloat16, **kw)
    deep = LeafTables.from_arrays(**{**fields, "g_order": np.array([6, 0, 0, 1, 0, 0],
                                                                    np.int32)})
    with pytest.raises(ValueError, match="order 6"):
        make_leaf_evaluator(deep, **kw)


def test_poly_table_is_the_softplus_derivatives():
    table = leaf_eval._poly_table()
    for k, poly in enumerate(_softplus_derivs(5), start=1):
        terms = [tuple(table[k, 1 + 3 * t:4 + 3 * t]) for t in range(table[k, 0])]
        assert terms == [(i, j, c) for (i, j), c in poly.items()]
    assert table[0, 0] == 0 and math.comb(4, 2) == 6
