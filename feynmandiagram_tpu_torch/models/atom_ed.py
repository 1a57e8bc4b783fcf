"""Exact-diagonalization (ED) oracle for small Hubbard clusters.

Port of ``feynmandiagram_tpu/models/atom_ed.py``, the counterpart of the
reference's Atom package
(FeynmanDiagram.jl/example/strong_coupling_expansion/Atom/src/hilbert.jl,
green.jl:21-140, hubbard.jl:34-60): a binary Fock space with
Jordan-Wigner fermion signs, an eigen-decomposed model (energies,
partition sum, rotated ladder operators), thermal averages, and
imaginary-time Green's functions.  The Fock space, the Hamiltonian and the
eigen-decomposition are numpy on the host, as in the JAX package.  The
Green's functions run in float64 on ``device`` (the CUDA card unless the
caller passes ``device="cpu"``): ``EDModel.g_tau``, the 1-body G(τ), as a
Lehmann spectral sum, one einsum over a whole τ batch, and ``gn_tau``, the
2N-point function, as a time-ordered matrix chain over scalar τs.

This is the end-to-end physics oracle: the ED self-energy
Σ = iω + μ − 1/G of the Hubbard atom must reproduce the closed-form
``models.hubbard_atom.exact_sigma`` (an independent formula from the
reference docs), and at U=0 the connected 4-point function must vanish
while the full one obeys Wick's theorem.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.dtypes import default_device

UP, DOWN = 0, 1


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


class FockSpace:
    """Binary Fock space of ``n_sites`` sites with spin up/down fermions.

    State index = sum_s (n_up[s] << s) | (sum_s n_down[s] << s) << n_sites;
    dimension 4**n_sites.  Operators are dense numpy matrices with
    Jordan-Wigner sign strings in the fixed mode order
    (site 0 up, site 1 up, ..., site 0 down, site 1 down, ...).
    """

    def __init__(self, n_sites: int):
        self.n_sites = n_sites
        self.dim = 4 ** n_sites
        self.n_modes = 2 * n_sites

    def mode(self, site: int, spin: int) -> int:
        return site + (self.n_sites if spin == DOWN else 0)

    def creation(self, site: int, spin: int) -> np.ndarray:
        """Dense matrix of c†_{site,spin} with JW fermion signs."""
        m = self.mode(site, spin)
        dim = self.dim
        out = np.zeros((dim, dim))
        for state in range(dim):
            if (state >> m) & 1:
                continue  # already occupied
            # JW string: (-1)^{number of occupied modes below m}
            sign = 1 - 2 * (bin(state & ((1 << m) - 1)).count("1") & 1)
            out[state | (1 << m), state] = sign
        return out

    def density(self, site: int, spin: int) -> np.ndarray:
        c = self.creation(site, spin)
        return c @ c.T


@dataclass
class EDModel:
    """Eigen-decomposed model: energies, partition sum, and ladder
    operators rotated to the eigenbasis (green.jl Model struct)."""
    beta: float
    energies: np.ndarray          # [dim], shifted so min(E) == 0
    z: float                      # partition sum at the shifted energies
    c_plus: List[np.ndarray]      # creation ops per mode, eigenbasis
    c_minus: List[np.ndarray]

    @classmethod
    def build(cls, beta: float, h: np.ndarray,
              c_plus_fock: Sequence[np.ndarray]) -> "EDModel":
        e, u = np.linalg.eigh(h)
        e = e - e.min()                   # exp(-beta*E) stays finite
        z = float(np.exp(-beta * e).sum())
        cp = [u.T @ c @ u for c in c_plus_fock]
        cm = [c.T for c in cp]
        return cls(beta, e, z, cp, cm)

    def thermal_avg(self, op_fock_eig: np.ndarray) -> float:
        """<O> = tr(e^{-beta H} O) / Z (op already in the eigenbasis)."""
        w = np.exp(-self.beta * self.energies)
        return float(np.einsum("i,ii->", w, op_fock_eig) / self.z)

    def g_tau(self, taus, mode_out: int = 0, mode_in: int = 0, *,
              device=None) -> torch.Tensor:
        """g(τ) = <T_τ c_{out}(τ) c†_{in}(0)> for τ ∈ (-β, β), batched.

        Lehmann spectral sum over eigenpairs, one einsum per τ batch:
        for τ > 0, g = (1/Z) Σ_{mn} e^{-(β-τ)E_m} e^{-τ E_n}
        <m|c|n><n|c†|m>; antiperiodic continuation for τ < 0.  Matches
        the free kernel e^{-ετ}/(1+e^{-εβ}) at U=0 (the pipeline's
        ``models.free_fermion.green_kernel`` convention,
        hubbard.jl:42-52).  A float64 tensor on ``device`` (default: the
        CUDA card, ``RuntimeError`` without one).
        """
        device = _device(device)
        if not torch.is_tensor(taus):
            taus = np.asarray(taus, np.float64)   # a list of floats is float32 to torch
        taus = torch.as_tensor(taus, device=device).to(torch.float64).reshape(-1)
        sign = torch.where(taus >= 0, 1.0, -1.0).to(torch.float64)
        tpos = torch.where(taus >= 0, taus, taus + self.beta)
        e = _f64(self.energies, device)
        cm = _f64(self.c_minus[mode_out], device)
        cp = _f64(self.c_plus[mode_in], device)
        # weight[m, n] = <m|c|n><n|c†|m> ; g(τ) = w·exp couplings
        w = cm * cp.T                      # elementwise [m, n]
        # exponent [m, n, t] = -(β-τ) E_m - τ E_n
        expo = (-(self.beta - tpos)[None, None, :] * e[:, None, None]
                - tpos[None, None, :] * e[None, :, None])
        g = torch.einsum("mn,mnt->t", w, torch.exp(expo)) / self.z
        return sign * g

    def g_matsubara(self, n_freqs: int, mode_out: int = 0, mode_in: int = 0,
                    quad_points: int = 256, *, device=None) -> np.ndarray:
        """Ĝ(iω_n) = ∫_0^β dτ e^{iω_n τ} g(τ) for n = 0..n_freqs-1
        (fermionic ω_n = (2n+1)π/β), Gauss–Legendre quadrature over the
        smooth exponential-sum integrand; g(τ) by ``g_tau`` on ``device``,
        the quadrature on the host."""
        x, wq = np.polynomial.legendre.leggauss(quad_points)
        tau = 0.5 * self.beta * (x + 1.0)
        wq = 0.5 * self.beta * wq
        g = self.g_tau(tau, mode_out, mode_in, device=device).cpu().numpy()
        wn = (2 * np.arange(n_freqs) + 1) * math.pi / self.beta
        phase = np.exp(1j * wn[:, None] * tau[None, :])
        return phase @ (wq * g)

    def gn_tau(self, taus: Sequence[float], modes: Sequence[int],
               daggers: Sequence[bool], *, device=None) -> float:
        """Full time-ordered 2N-point function
        <T_τ o_1(τ_1) ... o_{2N}(τ_{2N})> with o_k = c or c† (green.jl
        GreenN semantics; equal times keep the given operator order,
        later-listed operators act first).  Scalar τs: the time-ordered
        matrix chain runs in float64 on ``device`` (default: the CUDA card).
        """
        device = _device(device)
        order = sorted(range(len(taus)), key=lambda k: -taus[k])
        # fermionic sign of the sorting permutation
        perm = list(order)
        sign = 1
        for i in range(len(perm)):
            while perm[i] != i:
                j = perm[i]
                perm[i], perm[j] = perm[j], perm[i]
                sign = -sign
        e = _f64(self.energies, device)
        ts = [self.beta] + [taus[k] for k in order] + [0.0]
        mat = torch.diag(torch.exp(-(ts[0] - ts[1]) * e))
        for pos, k in enumerate(order):
            op = self.c_plus[modes[k]] if daggers[k] else self.c_minus[modes[k]]
            mat = mat @ _f64(op, device) @ torch.diag(torch.exp(-(ts[pos + 1] - ts[pos + 2]) * e))
        return sign * float(torch.trace(mat)) / self.z

    def g2_connected(self, t1: float, t2: float, t3: float, t4: float,
                     m1: int, m2: int, m3: int, m4: int, *, device=None) -> float:
        """Connected 2-body function
        Gc(1,2;3,4) = <T c(1)c(2)c†(3)c†(4)> − [G(1;4)G(2;3) − G(1;3)G(2;4)]
        (green.jl Gnc via 2-partitions, specialized to N=2), every part on
        ``device``."""
        full = self.gn_tau([t1, t2, t3, t4], [m1, m2, m3, m4],
                           [False, False, True, True], device=device)
        g = lambda to, ti, mo, mi: float(self.g_tau(
            np.asarray([to - ti]), mo, mi, device=device)[0])
        wick = g(t1, t4, m1, m4) * g(t2, t3, m2, m3) \
            - g(t1, t3, m1, m3) * g(t2, t4, m2, m4)
        return full - wick


def hubbard_hamiltonian(fock: FockSpace, t: float, u: float, mu: float,
                        bonds: Sequence[Tuple[int, int]]) -> np.ndarray:
    """H = −t Σ_<ij>σ c†_iσ c_jσ + U Σ_i n_i↑ n_i↓ − μ Σ_iσ n_iσ
    (hubbard.jl fermiHubbard)."""
    dim = fock.dim
    h = np.zeros((dim, dim))
    for s in range(fock.n_sites):
        nu = fock.density(s, UP)
        nd = fock.density(s, DOWN)
        h += u * (nu @ nd) - mu * (nu + nd)
    for (i, j) in bonds:
        for spin in (UP, DOWN):
            ci = fock.creation(i, spin)
            cj = fock.creation(j, spin)
            h += -t * (ci @ cj.T)
    return h


def hubbard_atom_model(u: float, mu: float, beta: float) -> EDModel:
    """Single-site Hubbard atom (hubbard.jl hubbardAtom)."""
    fock = FockSpace(1)
    h = hubbard_hamiltonian(fock, 0.0, u, mu, [])
    return EDModel.build(beta, h, [fock.creation(0, UP),
                                   fock.creation(0, DOWN)])


def hubbard_dimer_model(t: float, u: float, mu: float, beta: float) -> EDModel:
    """Two-site Hubbard dimer (hubbard.jl hubbardAtom2)."""
    fock = FockSpace(2)
    h = hubbard_hamiltonian(fock, t, u, mu, [(0, 1), (1, 0)])
    cps = [fock.creation(s, sp) for sp in (UP, DOWN) for s in (0, 1)]
    return EDModel.build(beta, h, cps)
