"""The port's exact-diagonalization oracle (``models/atom_ed.py``) against
the JAX package's and against independent formulas.

Every case of ``tests/test_atom_ed.py`` runs on the port with
``device="cpu"``: the free-fermion kernel at U=0, the grand-canonical
density, the ED self-energy against the closed form, the N-body machinery
at N=1, Wick's theorem at U=0, the U>0 vertex, the first-order hopping
identity and the U=0 dimer.  The Green's functions (``g_tau``,
``g_matsubara``, ``gn_tau``, ``g2_connected``) are also held to the
reference's values on the same arguments at rtol 1e-12: the same float64
arithmetic, in torch here and in jax/numpy there, which may round the
einsum's and the matrix chain's sums in another order.  The ED Σ is held to
the port's own ``exact_sigma``, and the strong-coupling example's printed
table to the reference example's.
"""
import math
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.models import atom_ed as ref  # noqa: E402
from feynmandiagram_tpu_torch.models import atom_ed as port  # noqa: E402
from feynmandiagram_tpu_torch.models.hubbard_atom import exact_sigma  # noqa: E402

CPU = "cpu"
RTOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (U, mu, beta) of the atoms and (t, U, mu, beta) of the dimers compared
ATOMS = [(0.0, 0.4, 2.0), (1.7, 0.2, 1.1), (2.0, 0.3, 1.2), (3.0, 0.0, 1.0),
         (4.0, -0.3, 1.5)]
DIMERS = [(0.7, 0.0, 0.1, 0.9), (0.9, 0.0, 0.2, 1.4), (0.05, 2.0, 0.3, 1.2)]


def both(kind, *args):
    """The same model built by each package: (port, reference)."""
    name = "hubbard_atom_model" if kind == "atom" else "hubbard_dimer_model"
    return getattr(port, name)(*args), getattr(ref, name)(*args)


class TestFockSpace:
    def test_anticommutators(self):
        """{c_a, c†_b} = δ_ab, {c_a, c_b} = 0 with JW signs (2 sites)."""
        fock = port.FockSpace(2)
        modes = [(s, sp) for sp in (port.UP, port.DOWN) for s in (0, 1)]
        cs = {m: fock.creation(*m) for m in modes}
        for ma in modes:
            for mb in modes:
                anti = cs[ma].T @ cs[mb] + cs[mb] @ cs[ma].T
                expect = np.eye(fock.dim) if ma == mb else 0 * anti
                np.testing.assert_allclose(anti, expect, atol=1e-14)
                anti2 = cs[ma] @ cs[mb] + cs[mb] @ cs[ma]
                np.testing.assert_allclose(anti2, 0 * anti2, atol=1e-14)
                assert np.array_equal(cs[ma], ref.FockSpace(2).creation(*ma))

    def test_atom_spectrum(self):
        """Hubbard-atom energies are {0, -mu, -mu, U-2mu} (hubbard.jl:36)."""
        fock = port.FockSpace(1)
        u, mu = 3.0, 0.7
        h = port.hubbard_hamiltonian(fock, 0.0, u, mu, [])
        e = np.sort(np.linalg.eigvalsh(h))
        np.testing.assert_allclose(e, np.sort([0.0, -mu, -mu, u - 2 * mu]), atol=1e-12)

    @pytest.mark.parametrize("t,u,mu", [(0.0, 3.0, 0.7), (0.9, 0.0, 0.2), (0.3, 2.5, -0.4)])
    def test_hamiltonian_and_model_equal_reference(self, t, u, mu):
        """The host half is the reference's numpy code: the same matrices."""
        for n_sites, bonds in ((1, []), (2, [(0, 1), (1, 0)])):
            h = port.hubbard_hamiltonian(port.FockSpace(n_sites), t, u, mu, bonds)
            assert np.array_equal(h, ref.hubbard_hamiltonian(ref.FockSpace(n_sites), t, u,
                                                              mu, bonds))
        m, r = both("dimer", t, u, mu, 1.3)
        assert m.z == r.z and np.array_equal(m.energies, r.energies)
        assert all(np.array_equal(a, b) for a, b in zip(m.c_plus, r.c_plus))


class TestGreen:
    def test_free_atom_matches_kernel(self):
        """U=0 atom: g(τ) equals the free kernel e^{-ετ}/(1+e^{-εβ}) with
        ε=-mu, incl. the antiperiodic τ<0 branch."""
        beta, mu = 2.0, 0.4
        m = port.hubbard_atom_model(0.0, mu, beta)
        taus = np.asarray([-1.7, -0.3, 0.11, 0.9, 1.93])
        got = m.g_tau(taus, device=CPU)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        eps = -mu
        want = []
        for t in taus:
            tp = t if t >= 0 else t + beta
            val = math.exp(-eps * tp) / (1 + math.exp(-eps * beta))
            want.append(val if t >= 0 else -val)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)

    def test_density(self):
        """<n> from thermal_avg matches the grand-canonical formula."""
        beta, u, mu = 1.3, 2.0, 0.5
        m = port.hubbard_atom_model(u, mu, beta)
        e_all = [0.0, -mu, -mu, u - 2 * mu]
        z = sum(math.exp(-beta * e) for e in e_all)
        n_exact = (math.exp(beta * mu) + math.exp(-beta * (u - 2 * mu))) / z
        cp = m.c_plus[0]
        np.testing.assert_allclose(m.thermal_avg(cp @ cp.T), n_exact, rtol=1e-12)

    @pytest.mark.parametrize("u,mu,beta", [(1.0, 0.0, 1.0), (2.5, 0.6, 0.8),
                                           (4.0, -0.3, 1.5)])
    def test_ed_sigma_matches_closed_form(self, u, mu, beta):
        """The ED Dyson self-energy Σ_std(iω_n) = iω_n + μ − 1/G_std(iω_n)
        reproduces the port's closed-form exact_sigma, which uses the
        reference's diagrammatic sign (−1 per interaction line): Σ_std =
        −exact_sigma, at the first four Matsubara frequencies."""
        m = port.hubbard_atom_model(u, mu, beta)
        ghat = m.g_matsubara(4, device=CPU)
        for n in range(4):
            wn = (2 * n + 1) * math.pi / beta
            sig = 1j * wn + mu - 1.0 / (-ghat[n])
            np.testing.assert_allclose(sig, -exact_sigma(wn, u, beta, mu), rtol=1e-8,
                                       atol=1e-10)

    def test_gn_reduces_to_g(self):
        """The 2-point case of the N-body machinery equals g_tau."""
        m = port.hubbard_atom_model(1.7, 0.2, 1.1)
        for tau in (0.3, 0.9):
            full = m.gn_tau([tau, 0.0], [0, 0], [False, True], device=CPU)
            np.testing.assert_allclose(full, float(m.g_tau([tau], device=CPU)[0]),
                                       rtol=1e-12)

    def test_wick_at_u0(self):
        """U=0: the connected 4-point vanishes, for same-spin and mixed-spin
        legs, atom and dimer."""
        for model in (port.hubbard_atom_model(0.0, 0.3, 1.2),
                      port.hubbard_dimer_model(0.7, 0.0, 0.1, 0.9)):
            ts = (0.8, 0.35, 0.6, 0.1)
            for modes in ((0, 0, 0, 0), (0, 1, 1, 0)):
                gc = model.g2_connected(*ts, *modes, device=CPU)
                assert abs(gc) < 1e-10, (modes, gc)

    def test_connected_nonzero_at_u(self):
        """U>0 atom: the connected 4-point (the vertex) is nonzero."""
        m = port.hubbard_atom_model(3.0, 0.0, 1.0)
        gc = m.g2_connected(0.8, 0.35, 0.6, 0.1, 0, 1, 1, 0, device=CPU)
        assert abs(gc) > 1e-3, gc

    def test_hopping_expansion_first_order(self):
        """The dimer's off-diagonal ED Green's function equals one hopping
        line joining two exact atomic propagators, G_01 = t·g_atom², with
        residual O(t³)."""
        u, mu, beta = 2.0, 0.3, 1.2
        g_at = port.hubbard_atom_model(u, mu, beta).g_matsubara(2, device=CPU)
        for t in (0.02, 0.04):
            g01 = port.hubbard_dimer_model(t, u, mu, beta).g_matsubara(2, 0, 1, device=CPU)
            for n in range(2):
                err = abs(g01[n] - t * g_at[n] ** 2)
                assert err < 0.05 * t ** 3, (t, n, err)

    def test_dimer_u0_matches_two_level(self):
        """U=0 dimer: site-diagonal g(τ) is the equal mix of the bonding/
        antibonding free kernels (ε = ∓t − μ)."""
        t, mu, beta = 0.9, 0.2, 1.4
        m = port.hubbard_dimer_model(t, 0.0, mu, beta)
        taus = np.asarray([0.2, 0.7, 1.1])
        got = m.g_tau(taus, 0, 0, device=CPU).numpy()
        want = np.zeros_like(got)
        for eps in (-t - mu, t - mu):
            want += 0.5 * np.exp(-eps * taus) / (1 + math.exp(-eps * beta))
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_default_device_raises_without_cuda(self):
        """The Green's functions run on the card unless asked for the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is valid")
        m = port.hubbard_atom_model(1.0, 0.0, 1.0)
        for call in (lambda: m.g_tau([0.1]), lambda: m.g_matsubara(1),
                     lambda: m.gn_tau([0.3, 0.0], [0, 0], [False, True]),
                     lambda: m.g2_connected(0.8, 0.35, 0.6, 0.1, 0, 1, 1, 0)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


class TestAgainstReference:
    @pytest.mark.parametrize("kind,args", [("atom", a) for a in ATOMS]
                             + [("dimer", d) for d in DIMERS])
    def test_g_tau_and_g_matsubara(self, kind, args):
        m, r = both(kind, *args)
        beta = args[-1]
        taus = np.linspace(-beta, beta, 41)[1:-1]
        modes = [(0, 0)] if kind == "atom" else [(0, 0), (0, 1), (1, 0), (2, 2), (3, 1)]
        for mo, mi in modes:
            got = m.g_tau(taus, mo, mi, device=CPU).numpy()
            want = np.asarray(r.g_tau(taus, mo, mi))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
            got = m.g_matsubara(3, mo, mi, device=CPU)
            want = r.g_matsubara(3, mo, mi)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())

    @pytest.mark.parametrize("kind,args", [("atom", a) for a in ATOMS[1:]]
                             + [("dimer", d) for d in DIMERS])
    def test_gn_tau_and_g2_connected(self, kind, args):
        m, r = both(kind, *args)
        beta = args[-1]
        rng = np.random.default_rng(len(args) + int(10 * beta))
        legs = [(0, 0, 0, 0), (0, 1, 1, 0)] + ([(0, 2, 2, 0), (1, 3, 3, 1)]
                                                if kind == "dimer" else [])
        for modes in legs:
            ts = [float(t) for t in rng.random(4) * beta]
            got = m.g2_connected(*ts, *modes, device=CPU)
            want = r.g2_connected(*ts, *modes)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
            daggers = [False, True, False, True]
            got = m.gn_tau(ts, modes, daggers, device=CPU)
            np.testing.assert_allclose(got, r.gn_tau(ts, modes, daggers), rtol=RTOL,
                                       atol=1e-15)


def test_strong_coupling_example_prints_the_reference_table(capsys, monkeypatch):
    """The port's example (on the CPU) prints the reference example's
    table, letter for letter."""
    from feynmandiagram_tpu_torch.examples import strong_coupling_expansion

    monkeypatch.setattr("sys.argv", ["strong_coupling_expansion.py"])
    runpy.run_path(os.path.join(REPO, "examples", "strong_coupling_expansion.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    strong_coupling_expansion.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 15
    strong_coupling_expansion.main(["3.0", "0.1", "0.7", "--device", "cpu"])
    other = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["strong_coupling_expansion.py", "3.0", "0.1", "0.7"])
    runpy.run_path(os.path.join(REPO, "examples", "strong_coupling_expansion.py"),
                   run_name="__main__")
    assert other == capsys.readouterr().out and "U=3.0" in other
