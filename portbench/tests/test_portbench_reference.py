"""The plain reference against the port's float64 plain path on the CPU, at
small sizes: Gamma4 at order 2, and config 4's counterterm series of Sigma at
order 2; and the reference's leaf forms against their definitions."""
import math

import numpy as np
import pytest
import torch

from portbench import bench
from portbench.reference import physics
from portbench.tests._cells import CALL_TRAFFIC, small_cell

# The two sides agree but for tau = 0, which the port reads as -1e-10 and the
# reference as 0^- exactly: a relative change of about 1e-10 in such a
# propagator, which the counterterms' factors of tau carry to 1.4e-9 of a
# root's scale (Sigma's order-(1, 0) and (2, 0) roots at order 2); float64
# rounding alone is some 1e-15, as the roots without such a propagator show.
RTOL = 1e-8


@pytest.mark.parametrize("config", ["gamma4-o4", "sigma4-ct2"])
def test_reference_equals_the_ports_float64_plain_path(config):
    cell = small_cell(config, CALL_TRAFFIC, {"root_err": 1e-5}, order=2)
    compiled, series, _ = bench.build_program(cell, "cpu", torch.float64, None)
    reference = bench.build_reference(cell, series)
    rng = np.random.default_rng(7)
    varK = torch.from_numpy(rng.standard_normal((3, series.n_loop, 96)))
    varT = torch.from_numpy(rng.random((series.n_tau, 96)) * series.beta)
    got, want = compiled(varK, varT), reference(varK, varT)
    assert got.shape == want.shape and want.shape[0] == len(compiled.lowered.root_slots)
    scale = want.abs().amax(dim=1)
    assert ((got - want).abs().amax(dim=1) <= RTOL * scale).all()


def _green_closed(tau, eps, beta):
    n = 1.0 / (1.0 + math.exp(-beta * eps))
    return math.exp(-eps * tau) * n if tau > 0 else -math.exp(-eps * (tau + beta)) * n


@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("tau", [0.31, -0.12, 0.0])
def test_green_counterterm_is_the_taylor_coefficient(order, tau):
    """(-1)^n / n! d^n G / d eps^n against central differences of the closed
    form, at a few energies."""
    beta, h = 0.5, 1e-2
    for eps in (-2.3, 0.4, 5.0):
        t = torch.tensor([tau], dtype=torch.float64)
        got = float(physics.green(t, torch.tensor([eps], dtype=torch.float64), beta, order))
        # the n-th central difference over 2h steps, error O(h^2)
        diff = sum((-1) ** k * math.comb(order, k) * _green_closed(tau, eps + (order / 2 - k) * h, beta)
                   for k in range(order + 1)) / h ** order
        want = (-1) ** order / math.factorial(order) * diff
        assert got == pytest.approx(want, rel=1e-3, abs=1e-9)


def test_interaction_counterterms():
    q2 = torch.tensor([0.0, 0.7, 9.0], dtype=torch.float64)
    v = 8 * math.pi / (q2 + 1.3)
    assert torch.allclose(physics.interaction(q2, 1.3, 0, "lambda_power"), v)
    assert torch.allclose(physics.interaction(q2, 1.3, 2, "lambda_power"), v * (1.3 / (q2 + 1.3)) ** 2)
    assert torch.allclose(physics.interaction(q2, 1.3, 2, "taylor"), v / (q2 + 1.3) ** 2)
