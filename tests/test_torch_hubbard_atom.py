"""The port's Hubbard-atom oracle against the JAX package and the closed form.

``build_sigma_evaluator``'s function, port and reference, on the same numpy
``varT`` in float64: the two packages lower the same diagrams with their own
host pipelines, evaluate the graph, and apply the Matsubara phase as real
cos/sin channels, so they agree row by row.  Tolerance rtol 1e-12 plus
1e-12 * max|ref|: the two packages write the G kernel differently, so it
differs in the last digits, and the sums over roots run in another order.  The port's ``sigma_mc`` draws its own numbers
(``torch.Generator``, not ``jax.random``), so it is held to the closed-form
series at ``tests/test_hubbard_atom.py``'s thresholds and seeds instead.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from feynmandiagram_tpu.models import hubbard_atom as ref  # noqa: E402
from feynmandiagram_tpu_torch.models import hubbard_atom as port  # noqa: E402
import chip_smoke  # noqa: E402

BETA, U = 2.3, 1.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _varT(num_tau, batch=512, seed=0):
    """Seeded varT in [0, beta), varT[0] = 0, with equal tau pairs among
    the samples so that G is read at tau = 0 (taken as 0^-)."""
    rng = np.random.default_rng(seed + num_tau)
    varT = rng.random((num_tau, batch)) * BETA
    varT[0] = 0.0
    if num_tau > 1:
        varT[1, :64] = 0.0                 # t1 == t0
    if num_tau > 2:
        varT[2, 64:128] = varT[1, 64:128]  # t2 == t1
    return varT


@pytest.mark.parametrize("mu", [0.0, 0.3])
@pytest.mark.parametrize("matsubara_n", [0, 1])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_fn_matches_jax(order, matsubara_n, mu):
    kw = dict(mu=mu, matsubara_n=matsubara_n)
    want = ref.build_sigma_evaluator(order, BETA, dtype=jnp.float64, **kw)
    got = port.build_sigma_evaluator(order, BETA, device="cpu", dtype=torch.float64, **kw)
    assert got.order == want.order == order and got.num_tau == want.num_tau
    varT = _varT(got.num_tau, seed=order + 10 * matsubara_n)
    u = 0.7
    expected = np.asarray(want.fn(jnp.asarray(varT), u))
    out = got.fn(varT, u)
    assert out.shape == expected.shape == (2, varT.shape[1]) and out.dtype == torch.float64
    assert np.isfinite(expected).all() and np.abs(expected).max() > 0
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-12,
                               atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize("mu", [0.0, 0.3, -0.4])
@pytest.mark.parametrize("u", [0.0, 1e-3, 1.0, 2.5])
@pytest.mark.parametrize("beta", [0.5, 2.3, 10.0])
def test_closed_form_equals_reference(beta, u, mu):
    """The same arithmetic: exactly equal."""
    for n in (0, 1, -1, 3):
        w = math.pi * (2 * n + 1) / beta
        assert port.exact_sigma(w, u, beta, mu) == ref.exact_sigma(w, u, beta, mu)
        assert port.exact_sigma(complex(0.1, w), u, beta, mu) == ref.exact_sigma(
            complex(0.1, w), u, beta, mu)


@pytest.mark.parametrize("beta", [0.5, 2.3, 10.0])
def test_power_series_equals_reference(beta):
    for max_order in range(1, 6):
        assert port.sigma_power_series(beta, max_order) == ref.sigma_power_series(
            beta, max_order)
    with pytest.raises(ValueError):
        port.sigma_power_series(beta, 6)


def test_sigma_mc_order1_exact():
    """No free tau variables: the estimate is deterministic, Sigma1 = -U/2."""
    mean, _ = port.sigma_mc(1, U, BETA, batch=64, chunks=2, device="cpu")
    assert mean.real == pytest.approx(-U / 2, rel=1e-12)
    assert mean.imag == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("order,batch,chunks,seed,floor", [
    (2, 4096, 8, 1, 1e-4), (3, 4096, 8, 2, 3e-4), (4, 8192, 12, 3, 5e-4)])
def test_sigma_mc_vs_series(order, batch, chunks, seed, floor):
    expect = port.sigma_power_series(BETA)[order - 1] * U ** order
    mean, err = port.sigma_mc(order, U, BETA, batch=batch, chunks=chunks, seed=seed,
                              device="cpu")
    assert abs(mean.real - expect.real) < 5 * max(abs(err.real), floor)
    assert abs(mean.imag - expect.imag) < 5 * max(abs(err.imag), floor)


def test_sigma_mc_is_seeded():
    kw = dict(batch=256, chunks=3, device="cpu")
    a, b = port.sigma_mc(2, U, BETA, seed=4, **kw), port.sigma_mc(2, U, BETA, seed=4, **kw)
    assert a == b and a != port.sigma_mc(2, U, BETA, seed=5, **kw)


def test_no_device_raises_without_cuda():
    """The entry points run on the card unless the caller passes a device."""
    if torch.cuda.is_available():
        assert port.build_sigma_evaluator(2, BETA).fn(_varT(2), U).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_sigma_evaluator(2, BETA)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.sigma_mc(1, U, BETA, batch=8, chunks=1)


def test_levels_with_buckets_per_order():
    """chip_smoke's expected launches a pass, one per level that holds
    buckets, are those of the port's own lowering at orders 1-5."""
    from feynmandiagram_tpu_torch.ops.evaluator import level_buckets
    counts = {order: sum(1 for lvl in port.lower_sigma(order)[1].levels if level_buckets(lvl))
              for order in chip_smoke.HUBBARD_ORDERS}
    assert counts == chip_smoke.HUBBARD_BUCKET_LEVELS


def test_runs_with_jax_blocked():
    """A fresh interpreter with jax and the JAX package blocked runs the
    module and the example on the CPU and loads no module of either."""
    script = """
import sys
sys.modules["jax"] = None
sys.modules["feynmandiagram_tpu"] = None
from feynmandiagram_tpu_torch.examples import hubbard_atom
hubbard_atom.main(["--device", "cpu"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "feynmandiagram_tpu") and sys.modules[m])
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", script], check=True, env=env, timeout=300)
