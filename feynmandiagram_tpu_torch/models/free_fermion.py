"""Free-fermion imaginary-time propagator and its frequency-derivative tower.

Port of ``feynmandiagram_tpu/models/free_fermion.py``.  The kernel is

    tau in (0, beta]:   G =  exp(-eps*tau) / (1 + exp(-eps*beta))
    tau in (-beta, 0]:  G = -exp(-eps*tau) / (1 + exp( eps*beta))

with tau == 0 read as tau -> 0^-.  Both branches are one form,
``G = sign * exp(phi)`` with ``phi = -eps*tau - softplus(c*eps)``, where
``c = -beta`` for tau > 0 and ``c = beta`` otherwise, so G never overflows.
Since ``softplus(beta*eps) = softplus(-beta*eps) + beta*eps``, the same G is
``sign * exp(-eps*tau1 - softplus(-beta*eps))`` with ``tau1 = tau`` for
tau > 0 and ``tau + beta`` otherwise: a factor of tau alone and one of eps
alone (``green_tau_parts``, ``green_eps_part``), which the leaf phase's
kernels (``csrc/leaf_eval.cu``) evaluate once per tau pair and per momentum
and combine per leaf; the tests hold those kernels' plain version to them.

The reference differentiates with nested ``jax.grad``.  Here the derivatives
are closed-form: ``d^n G/d eps^n = G * B_n(phi', ..., phi^(n))`` with the
complete Bell polynomials ``B``, ``phi' = -tau - c*s``, and
``phi^(k) = -c^k * softplus^(k)(c*eps)`` for k >= 2, each softplus derivative
a polynomial in ``s = sigmoid(u)`` and ``sbar = sigmoid(-u)``.  Every factor
is bounded, so no order overflows or yields NaN, in float32 as in float64.
``softplus`` is ``logaddexp(x, 0)`` as in ``jax.nn.softplus``; torch's own
softplus switches to ``x`` above its threshold and would put a kink into
the value and derivatives.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import torch

TAU_CUTOFF = 1e-10
MAX_DERIV_ORDER = 5

Poly = Dict[Tuple[int, int], int]   # {(i, j): coeff} for coeff * s^i * sbar^j


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


@lru_cache(maxsize=None)
def _softplus_derivs(n: int) -> Tuple[Poly, ...]:
    """``softplus^(k)(u)`` for k = 1..n as polynomials in s and sbar.

    softplus' = s; ds/du = s*sbar and dsbar/du = -s*sbar, so each derivative
    is ``(dP/ds - dP/dsbar) * s * sbar`` of the one before."""
    polys: List[Poly] = [{(1, 0): 1}]
    for _ in range(1, n):
        nxt: Poly = {}
        for (i, j), coef in polys[-1].items():
            if i:
                key = (i, j + 1)          # (i s^(i-1) sbar^j) * s sbar
                nxt[key] = nxt.get(key, 0) + coef * i
            if j:
                key = (i + 1, j)          # -(j s^i sbar^(j-1)) * s sbar
                nxt[key] = nxt.get(key, 0) - coef * j
        polys.append({k: v for k, v in nxt.items() if v})
    return tuple(polys)


def _green_parts(tau: torch.Tensor, eps: torch.Tensor, beta: float):
    tau, eps = torch.broadcast_tensors(tau, eps)
    tau = torch.where(tau.abs() < TAU_CUTOFF, tau.new_full((), -TAU_CUTOFF), tau)
    pos = tau > 0
    b = torch.full_like(tau, beta)
    c = torch.where(pos, -b, b)                       # d(u)/d(eps), u = c*eps
    sign = torch.where(pos, torch.ones_like(tau), -torch.ones_like(tau))
    u = c * eps
    g = sign * torch.exp(-eps * tau - _softplus(u))
    return tau, c, u, g


def green_tau_parts(tau: torch.Tensor, beta: float):
    """``(sign, tau1)`` of ``G = sign * exp(-eps*tau1 - softplus(-beta*eps))``:
    ``+1, tau`` for tau > 0 and ``-1, tau + beta`` otherwise."""
    tau = torch.where(tau.abs() < TAU_CUTOFF, tau.new_full((), -TAU_CUTOFF), tau)
    pos = tau > 0
    return pos.to(tau.dtype) * 2 - 1, torch.where(pos, tau, tau + beta)


def green_eps_part(eps: torch.Tensor, beta: float) -> torch.Tensor:
    """``softplus(-beta*eps)``, the factor of eps alone in
    ``green_tau_parts``' form of G."""
    return _softplus(-beta * eps)


def green_kernel(tau: torch.Tensor, eps: torch.Tensor, beta: float) -> torch.Tensor:
    """Batched stable fermionic kernel G(tau, eps, beta)."""
    return _green_parts(tau, eps, beta)[3]


def green_derive_tower(tau: torch.Tensor, eps: torch.Tensor, beta: float,
                       order: int) -> torch.Tensor:
    """(-1)^n / n! * d^n G / d eps^n, the G-counterterm leaf value at
    derivative order ``n``."""
    if not (0 <= order <= MAX_DERIV_ORDER):
        raise ValueError(f"derivative order {order} not supported")
    tau, c, u, g = _green_parts(tau, eps, beta)
    if order == 0:
        return g
    s, sbar = torch.sigmoid(u), torch.sigmoid(-u)
    dphi = [-tau - c * s]                              # phi', phi'', ...
    for k, poly in enumerate(_softplus_derivs(order)[1:], start=2):
        sp_k = sum(coef * s ** i * sbar ** j for (i, j), coef in poly.items())
        dphi.append(-(c ** k) * sp_k)
    bell = [torch.ones_like(g)]                        # complete Bell polynomials
    for m in range(order):
        bell.append(sum(math.comb(m, k) * bell[m - k] * dphi[k] for k in range(m + 1)))
    return g * bell[order] * ((-1.0) ** order / math.factorial(order))
