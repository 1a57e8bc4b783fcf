"""The port's G and V physics against the JAX package's, in float64.

The JAX G tower is nested ``jax.grad``; the port's is closed-form (Bell
polynomials of the exponent's derivatives).  Where a derivative is a sum of
cancelling terms both carry rounding error of the terms' size, and the
nested-grad tower carries more of it (up to ~2e-10 relative at order 5
against a 50-digit reference, the port ~5e-14).  So the comparison with JAX
is rtol 1e-12 plus an absolute 1e-12 of the sample's largest value, and a
second test holds the port alone to rtol 1e-12 pointwise against mpmath.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.models.free_fermion import (  # noqa: E402
    green_derive_tower as jax_tower, green_kernel as jax_green)
from feynmandiagram_tpu.models.yukawa import interaction_derive as jax_v  # noqa: E402
from feynmandiagram_tpu_torch.models import (TAU_CUTOFF, green_derive_tower,  # noqa: E402
                                             green_kernel, interaction_derive)

BETA = 0.5


def _points():
    """Both signs of tau, tau = 0 and |tau| < TAU_CUTOFF, tau = +-beta, and
    |eps * beta| >= 50."""
    rng = np.random.default_rng(0)
    tau = np.concatenate([rng.uniform(-BETA, BETA, 400),
                          [0.0, 0.5 * TAU_CUTOFF, -0.5 * TAU_CUTOFF, BETA, -BETA,
                           0.49, -0.49, 0.3, -0.3, 0.001, -0.001]])
    eps = np.concatenate([rng.uniform(-30.0, 30.0, 400),
                          [200.0, -200.0, 150.0, -150.0, 100.0, -100.0,
                           400.0, -400.0, 0.0, 1e-9, -1e-9]])
    return tau, eps


def _port(fn, *args):
    return fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in args)).numpy()


def test_green_kernel_matches_jax():
    tau, eps = _points()
    expected = np.asarray(jax_green(tau, eps, BETA))
    np.testing.assert_allclose(_port(green_kernel, tau, eps, BETA), expected,
                               rtol=1e-12, atol=0)


def test_green_factors_match_jax():
    """The leaf phase's form of G, ``sign * exp(-(eps*tau1 +
    softplus(-beta*eps)))`` from ``green_tau_parts`` and ``green_eps_part``,
    against the JAX package's kernel in float64 at rtol 1e-12, on the same
    points: both signs of tau, tau at and near 0, |eps*beta| up to 200."""
    from feynmandiagram_tpu_torch.models.free_fermion import green_eps_part, green_tau_parts
    tau, eps = _points()
    sign, tau1 = green_tau_parts(torch.from_numpy(tau), BETA)
    sp = green_eps_part(torch.from_numpy(eps), BETA)
    got = (torch.exp(-(torch.from_numpy(eps) * tau1 + sp)) * sign).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_green(tau, eps, BETA)), rtol=1e-12, atol=0)


@pytest.mark.parametrize("order", range(6))
def test_green_tower_matches_jax(order):
    tau, eps = _points()
    expected = np.asarray(jax_tower(tau, eps, BETA, order))
    got = _port(green_derive_tower, tau, eps, BETA, order)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, expected, rtol=1e-12,
                               atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_green_tower_matches_high_precision(order):
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 40
    rng = np.random.default_rng(order)
    tau = rng.uniform(-BETA, BETA, 40)
    eps = rng.uniform(-30.0, 30.0, 40)

    def g(t, e):
        t, e, b = mp.mpf(t), e, mp.mpf(BETA)
        if t > 0:
            return mp.exp(-e * t) / (1 + mp.exp(-e * b))
        return -mp.exp(-e * t) / (1 + mp.exp(e * b))

    exact = np.array([float(mp.diff(lambda e: g(t, e), mp.mpf(e0), order)
                            * (-1) ** order / mp.factorial(order))
                      for t, e0 in zip(tau, eps)])
    got = _port(green_derive_tower, tau, eps, BETA, order)
    np.testing.assert_allclose(got, exact, rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_green_tower_finite_at_large_eps_beta(dtype):
    """No order overflows: |eps*beta| up to 500 is finite in float32 too."""
    tau = torch.tensor([0.0, 0.49, -0.49, 0.001, 0.25, -0.25], dtype=dtype)
    eps = torch.tensor([1000.0, -1000.0, 300.0, -300.0, 0.0, 1000.0], dtype=dtype)
    for order in range(6):
        assert torch.isfinite(green_derive_tower(tau, eps, BETA, order)).all(), order


def test_green_tower_rejects_order_6():
    with pytest.raises(ValueError):
        green_derive_tower(torch.zeros(1, dtype=torch.float64),
                           torch.zeros(1, dtype=torch.float64), BETA, 6)


@pytest.mark.parametrize("convention", ["lambda_power", "taylor"])
def test_interaction_matches_jax(convention):
    q2 = np.random.default_rng(1).uniform(0.0, 20.0, 200)
    for lam in (0.5, 1.0, 3.0):
        for order in range(4):
            expected = np.asarray(jax_v(q2, lam, order, convention=convention))
            got = interaction_derive(torch.from_numpy(q2), lam, order,
                                     convention=convention).numpy()
            np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0)


def test_interaction_unknown_convention_raises():
    with pytest.raises(ValueError):
        interaction_derive(torch.ones(2, dtype=torch.float64), 1.0, 1, convention="x")
