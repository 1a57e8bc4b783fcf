"""The leaves of the diagram series, in float64, from their definitions.

- A bare propagator of momentum ``k`` between times ``t_in`` and ``t_out``
  is the free fermion's imaginary-time kernel at ``eps = |k|^2 - kF^2``
  and ``tau = t_out - t_in``: ``exp(-eps*tau) / (1 + exp(-beta*eps))`` for
  ``tau > 0`` and ``-exp(-eps*(tau + beta)) / (1 + exp(-beta*eps))`` for
  ``tau <= 0`` (``tau = 0`` read as ``0^-``).  A G counterterm of order
  ``n`` is ``(-1)^n / n! d^n G / d eps^n``, the coefficient of the
  chemical-potential shift ``mu^n`` in ``G(eps - mu)``; it is taken here as
  the ``n``-th coefficient of G's Taylor series in ``eps``, a product of
  the series of ``exp(-h tau)`` and of the reciprocal of ``1 + exp(-beta
  (eps + h))``.
- An instant interaction of momentum ``q`` is the screened Coulomb
  (Yukawa) potential ``8 pi / (q^2 + lam)``; its counterterm of order
  ``n`` is ``V (lam / (q^2 + lam))^n`` in the ``lambda_power`` convention
  and ``(-1)^n 8 pi / (q^2 + lam)^(n + 1)`` in the ``taylor`` one.

Nothing here is taken from the program: the forms are the definitions
above, written out plainly.
"""
from __future__ import annotations

import math

import torch

EIGHT_PI = 8.0 * math.pi


def green(tau: torch.Tensor, eps: torch.Tensor, beta: float, order: int) -> torch.Tensor:
    """The bare propagator's order-``order`` counterterm at imaginary time
    ``tau`` and energy ``eps`` (float64 tensors of one shape)."""
    pos = tau > 0
    tau1 = torch.where(pos, tau, tau + beta)
    sign = torch.where(pos, 1.0, -1.0).to(tau.dtype)
    g0 = sign * torch.exp(-eps * tau1 - torch.logaddexp(-beta * eps, torch.zeros_like(eps)))
    if order == 0:
        return g0
    # 1 + exp(-beta (eps + h)) over its value at h = 0: 1 + s sum_k (-beta h)^k / k!
    s = torch.sigmoid(-beta * eps)
    d = [None] + [s * ((-beta) ** k / math.factorial(k)) for k in range(1, order + 1)]
    rho = [torch.ones_like(eps)]
    for m in range(1, order + 1):
        rho.append(-sum(d[k] * rho[m - k] for k in range(1, m + 1)))
    coef = sum(((-tau1) ** k / math.factorial(k)) * rho[order - k] for k in range(order + 1))
    return ((-1.0) ** order) * g0 * coef


def interaction(q2: torch.Tensor, lam: float, order: int, convention: str) -> torch.Tensor:
    """The instant interaction's order-``order`` counterterm at ``|q|^2 = q2``."""
    inv = 1.0 / (q2 + lam)
    if convention == "lambda_power":
        return EIGHT_PI * inv * (lam * inv) ** order
    if convention == "taylor":
        return ((-1.0) ** order) * EIGHT_PI * inv ** (order + 1)
    raise ValueError(f"unknown interaction convention {convention!r}")
