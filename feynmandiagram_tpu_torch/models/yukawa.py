"""Statically screened (Yukawa) interaction and its counterterm powers.

Port of ``feynmandiagram_tpu/models/yukawa.py``: V(q; lam) = 8*pi/(q^2 + lam),
and the interaction-counterterm leaf at derivative order n in either
convention ('lambda_power', the reference MC examples' V*(lam/(q^2+lam))^n,
or 'taylor', 1/n! d^n V/d lam^n).
"""
from __future__ import annotations

import math

import torch

EIGHT_PI = 8.0 * math.pi


def yukawa_interaction(q2: torch.Tensor, lam: float) -> torch.Tensor:
    return EIGHT_PI / (q2 + lam)


def interaction_derive(q2: torch.Tensor, lam: float, order: int, *,
                       convention: str = "lambda_power") -> torch.Tensor:
    """Interaction-counterterm leaf value at derivative order ``order``.

    - 'lambda_power': V * (lam/(q^2+lam))^order
    - 'taylor':      (-1)^n * 8pi/(q^2+lam)^(n+1)
    """
    inv = 1.0 / (q2 + lam)
    if convention == "lambda_power":
        return EIGHT_PI * inv * (lam * inv) ** order
    if convention == "taylor":
        return ((-1.0) ** order) * EIGHT_PI * inv ** (order + 1)
    raise ValueError(f"unknown convention {convention}")
