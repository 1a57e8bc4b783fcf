"""Hubbard-atom end-to-end physics oracle.

Port of ``feynmandiagram_tpu/models/hubbard_atom.py``.  The Hubbard atom
H = U n_up n_down - mu (n_up + n_down) has a closed-form self-energy, so the
FULL pipeline — parquet sigma diagrams -> lowering -> batched graph
evaluation on the card -> Matsubara phase -> Monte-Carlo tau integration —
can be checked against an analytic answer order by order in U, an answer
known independently of both packages.

Reference: docs/src/manual/hubbard_atom.md (closed form and the power series
at i*omega_0, mu=0) and the legacy MC test test/hubbard.jl:1-114 (leaf rules:
G leaf = kernelFermiT(tau, -mu, beta) with tau==0 -> 0^-, V leaf = U; root
phase exp(i*pi*(2n+1)/beta * (t_out - t_in))).

There is no momentum here: the atom is a single site, so the BareGreenId
momenta produced by the parquet builder are simply ignored by the leaf rules
(hubbard.jl:42-52 does the same).

The graph is lowered with ``sum_mode="bucketed"``: its sums run through the
gather-reduce kernel, one launch per level that holds buckets, and its
products as plain PyTorch (XLA ops in the reference).  The evaluator runs
eagerly; the reference's ``jax.jit`` of the whole function has no
counterpart yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ops.dtypes import default_device, default_dtype
from .free_fermion import green_kernel


def exact_sigma(iw, U: float, beta: float, mu: float = 0.0):
    """Closed-form Sigma(i*omega) of the Hubbard atom
    (hubbard_atom.md:55-58)."""
    iw = complex(0.0, iw) if not isinstance(iw, complex) else iw
    ebm = math.exp(beta * mu)
    ebu = math.exp(beta * U)
    num = U * ebm * (mu + iw) * (ebm + ebu)
    den = (ebu * (-mu + U - iw) + ebm * ebu * (-2 * mu + U - 2 * iw)
           - ebm * ebm * (mu + iw))
    return num / den


def sigma_power_series(beta: float, max_order: int = 5) -> List[complex]:
    """Coefficients of Sigma(i*omega_0) = sum_o c_o U^o at mu=0
    (hubbard_atom.md:60-62); c_o includes everything except the U^o power."""
    pi = math.pi
    coeffs = [
        -0.5,
        (pi + 2j) * beta / (8 * pi),
        -(pi ** 2 - 4) * beta ** 2 / (32 * pi ** 2),
        -(24j - 12 * pi + 6j * pi ** 2 + pi ** 3) * beta ** 3 / (384 * pi ** 3),
        (-48 - 48j * pi - 24 * pi ** 2 + 12j * pi ** 3 + 5 * pi ** 4)
        * beta ** 4 / (1536 * pi ** 4),
    ]
    if max_order > len(coeffs):
        raise ValueError("series known to order 5 only")
    return coeffs[:max_order]


@dataclass
class HubbardSigma:
    """One diagram order of the Hubbard-atom self-energy, compiled."""
    order: int
    num_tau: int           # totalTauNum: varT rows (varT[0] pinned to 0)
    fn: Callable           # (varT[num_tau, batch], U) -> [2, batch] (re, im)


def lower_sigma(order: int):
    """The order-``order`` sigma diagrams (``Interaction(UpDown, Instant)``),
    optimized and lowered with ``sum_mode="bucketed"``: ``(para, lowered,
    tables, ext_ts)``, the ``LeafTables`` of the lowering and each root's
    (t_in, t_out), 1-based."""
    from ..frontends import Instant, UpDown
    from ..frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
    from ..computational_graph import optimize_inplace
    from ..backends.compile import leafmap_of, leaf_graphs_of
    from ..ops import lower
    from ..ops.leaf_eval import leaf_tables_from_lowered

    para = DiagPara(type=SigmaDiag, innerLoopNum=order, hasTau=True,
                    interaction=(Interaction(UpDown, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    rows = sigma(para, extK, False)
    roots = [r["diagram"] for r in rows]
    ext_ts = [tuple(r["extT"]) for r in rows]
    optimize_inplace(roots, level=1)

    leafmap = leafmap_of(roots)
    lowered = lower(roots, leafmap, sum_mode="bucketed")
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots),
                                      para.totalLoopNum)
    return para, lowered, tables, ext_ts


def build_sigma_evaluator(order: int, beta: float, *, mu: float = 0.0,
                          matsubara_n: int = 0, device=None, dtype=None,
                          kernel: bool = True) -> HubbardSigma:
    """Build the order-``order`` sigma diagrams into one function
    (varT, U) -> per-sample Sigma integrand (phase included), real and
    imaginary parts as rows of a ``[2, batch]`` tensor on ``device``.

    ``device=None`` is the CUDA device (``RuntimeError`` without one);
    ``dtype`` follows the device as in ``make_evaluator``.  The index tables
    are uploaded here, once.  ``kernel=False`` runs the graph's sums through
    the kernel's plain version on any device: the reference the kernel is
    checked against."""
    from ..ops.evaluator import make_evaluator

    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    para, lowered, tables, ext_ts = lower_sigma(order)
    if (tables.g_order != 0).any() or (tables.v_order != 0).any():
        raise AssertionError("Hubbard oracle has no counterterm leaves")

    graph_fn = make_evaluator(lowered, device=device, dtype=dtype, kernel=kernel)

    def index(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    g_leaves = np.where(tables.leaf_type == 1)[0]
    g_idx = index(g_leaves)
    v_idx = index(np.where(tables.leaf_type == 2)[0])
    g_tin = index(tables.tau_in[g_leaves] - 1)
    g_tout = index(tables.tau_out[g_leaves] - 1)
    omega = math.pi * (2 * matsubara_n + 1) / beta
    # (t_in, t_out) per root, 0-based into varT (hubbard.jl:37-40)
    root_tin = index([t[0] - 1 for t in ext_ts])
    root_tout = index([t[1] - 1 for t in ext_ts])
    num_leaves = lowered.num_leaves - len(lowered.const_slots)
    eps = torch.tensor(-mu, dtype=dtype, device=device)

    def fn(varT, U):
        # no complex dtype (as in the reference, which kept complex out of
        # the TPU's graph): the Matsubara phase is applied as real cos/sin
        # channels
        varT = torch.as_tensor(varT, device=device).to(dtype)
        batch = varT.shape[-1]
        leaf = torch.ones((num_leaves, batch), dtype=dtype, device=device)
        leaf[g_idx] = green_kernel(varT[g_tout] - varT[g_tin], eps, beta)
        leaf[v_idx] = U
        w = graph_fn(leaf)                               # [R, batch] real
        dt = varT[root_tout] - varT[root_tin]            # [R, batch]
        re = torch.sum(w * torch.cos(omega * dt), dim=0)
        im = torch.sum(w * torch.sin(omega * dt), dim=0)
        return torch.stack([re, im])                     # [2, batch]

    return HubbardSigma(order, para.totalTauNum, fn)


def _chunk_seed(seed: int, chunk: int) -> int:
    """A 64-bit seed for chunk ``chunk`` of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, chunk]).generate_state(1, np.uint64)[0])


def sigma_mc(order: int, U: float, beta: float, *, mu: float = 0.0,
             matsubara_n: int = 0, batch: int = 8192, chunks: int = 32,
             seed: int = 0, device=None, dtype=None) -> Tuple[complex, complex]:
    """Uniform-tau Monte-Carlo estimate of Sigma^(order)(i*omega_n).

    varT[0] is pinned to 0 (hubbard.jl:76-78); the remaining num_tau-1
    variables are uniform on [0, beta), drawn on the device by a
    ``torch.Generator`` seeded from ``seed`` and the chunk, so the integral
    is beta^(num_tau-1) * mean(integrand).  Returns (mean, stderr) with
    stderr reported per real/imag component.  The draws differ from the
    reference's ``jax.random`` ones for the same seed.
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    hs = build_sigma_evaluator(order, beta, mu=mu, matsubara_n=matsubara_n,
                               device=device, dtype=dtype)
    nfree = hs.num_tau - 1
    vol = beta ** nfree
    gen = torch.Generator(device=device)
    means = []
    for c in range(chunks):
        gen.manual_seed(_chunk_seed(seed, c))
        varT = torch.zeros((hs.num_tau, batch), dtype=dtype, device=device)
        varT[1:] = torch.rand((nfree, batch), generator=gen, dtype=dtype, device=device) * beta
        re, im = torch.mean(hs.fn(varT, U), dim=1).tolist()
        means.append(complex(re, im) * vol)
    means = np.asarray(means)
    mean = means.mean()
    if chunks > 1:
        err = (means.real.std(ddof=1) + 1j * means.imag.std(ddof=1)) / math.sqrt(chunks)
    else:
        err = 0.0
    return mean, err
