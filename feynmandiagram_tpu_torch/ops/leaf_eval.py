"""Vectorized leaf evaluation: SoA leaf tables -> batched leaf values.

Port of ``feynmandiagram_tpu/ops/leaf_eval.py`` in the flat layout.
``LeafTables`` and ``leaf_tables_from_lowered`` are the reference's numpy
code, re-homed here because the original file imports jax.  The evaluator
runs, per call:

1. ``loops = einsum(basis, varK)``, the LoopPool update as one matrix
   product, and ``q2 = |loops|^2`` per basis row; for the propagators
   ``eps = q2 - kF^2`` and ``softplus(-beta*eps)`` per basis row and
   ``tau = varT[out] - varT[in]`` per pair of times;
2. one vectorized physics call per (leaf type, derivative order) group,
   scattered into a ``[num_leaves, batch]`` buffer initialised to ones: a
   bare propagator (order 0) is ``sign * exp(-eps*tau1 - softplus)`` of
   rows gathered from step 1 (``models.free_fermion.green_tau_parts``).

Both steps compute in ``compute_dtype``, float64 by default whatever the
storage type, and each leaf is rounded once, as it is stored.  The JAX
package computes in the storage type; in float32 the exponent ``-eps*tau``
of a propagator then carries an absolute error of about ``|eps*tau|`` ulps,
which is the relative error of G: on Gamma4 at order 6 float32 leaves are
off by 2.4e-6 at the 99th percentile and 2.7e-5 at worst (on an H100),
enough to put a root past 1e-5 of the float64 pass, scale-relative.

The group index tables are built and uploaded to the device once.  The
LoopPool step runs in the profiler scope ``loops`` and each group in
``leafG{order}`` / ``leafV{order}``, the JAX package's scope names
(``utils.profiling.scope``: entered only while a profiler runs).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict

import numpy as np
import torch

from ..frontends import BareGreenId, BareInteractionId
from ..models.free_fermion import green_derive_tower, green_eps_part, green_tau_parts
from ..models.yukawa import interaction_derive
from .dtypes import default_device, default_dtype
from ..utils.profiling import scope


@dataclass
class LeafTables:
    """Static per-leaf metadata (SoA), slot-aligned with the lowered graph."""
    leaf_type: np.ndarray     # [L] int: 1=BareGreenId, 2=BareInteractionId
    g_order: np.ndarray       # [L] int: G-counterterm derivative order
    v_order: np.ndarray       # [L] int: V-counterterm derivative order
    tau_in: np.ndarray        # [L] int, 1-based tau index
    tau_out: np.ndarray       # [L] int, 1-based tau index
    loop_idx: np.ndarray      # [L] int, 0-based index into the loop basis
    loop_basis: np.ndarray    # [n_basis, max_loop_num]

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_type)

    @classmethod
    def from_arrays(cls, **arrays) -> "LeafTables":
        """Tables handed over as numpy arrays (for example the fields of the
        JAX package's ``LeafTables``); unknown or missing names raise."""
        names = {f.name for f in fields(cls)}
        if set(arrays) != names:
            raise ValueError(f"LeafTables needs exactly {sorted(names)}, "
                             f"got {sorted(arrays)}")
        return cls(**{k: np.asarray(v) for k, v in arrays.items()})


def leaf_tables_from_lowered(lowered, leaf_graphs: Dict[int, "Graph"],
                             max_loop_num: int) -> LeafTables:
    """Build LeafTables for the non-constant leaf slots of a LoweredGraph.

    ``leaf_graphs`` maps leaf uid -> leaf Graph (carrying DiagramId
    properties and derivative orders).

    A leaf's momentum takes the first basis row that is ``np.allclose`` to
    it (``rtol`` 1.49e-8, ``atol`` 1e-8), else becomes a new row.  The
    JAX package scans the rows one by one, which is quadratic in the
    leaves.  Here a momentum seen before, bit for bit, takes the row it
    took then (rows are only appended, so its first match cannot change),
    and any other is tested against all rows at once with ``np.isclose``,
    the test that ``np.allclose`` applies, so the tables are identical.
    """
    n_input = lowered.num_leaves - len(lowered.const_slots)
    leaf_type = np.zeros(n_input, np.int32)
    g_order = np.zeros(n_input, np.int32)
    v_order = np.zeros(n_input, np.int32)
    tau_in = np.ones(n_input, np.int32)
    tau_out = np.ones(n_input, np.int32)
    loop_idx = np.zeros(n_input, np.int32)
    basis = np.zeros((n_input, max_loop_num))   # rows 0 .. n_basis - 1 in use
    n_basis = 0
    row_of: Dict[bytes, int] = {}                # a momentum's bytes -> its row

    for uid, slot in lowered.leaf_uid_to_slot.items():
        if slot >= n_input:
            continue
        leaf = leaf_graphs[uid]
        diag_id = leaf.properties
        k = np.zeros(max_loop_num)
        extk = np.asarray(diag_id.extK, float)
        if len(extk) > max_loop_num:
            raise ValueError("extK longer than max_loop_num")
        k[:len(extk)] = extk
        key = k.tobytes()
        row = row_of.get(key)
        if row is None:
            hit = np.flatnonzero(np.isclose(basis[:n_basis], k, rtol=1.49e-8).all(axis=1))
            if hit.size:
                row = int(hit[0])
            else:
                row, basis[n_basis] = n_basis, k
                n_basis += 1
            row_of[key] = row
        loop_idx[slot] = row
        tau_in[slot], tau_out[slot] = diag_id.extT[0], diag_id.extT[1]
        orders = list(leaf.orders) + [0, 0]
        g_order[slot], v_order[slot] = orders[0], orders[1]
        if isinstance(diag_id, BareGreenId):
            leaf_type[slot] = 1
        elif isinstance(diag_id, BareInteractionId):
            leaf_type[slot] = 2
        else:
            raise ValueError(f"unsupported leaf id {type(diag_id)}")

    return LeafTables(leaf_type, g_order, v_order, tau_in, tau_out, loop_idx,
                      basis[:n_basis].copy())


def make_leaf_evaluator(tables: LeafTables, *, beta: float, kF: float, lam: float,
                        device=None, dtype=None, compute_dtype=torch.float64,
                        interaction_convention: str = "lambda_power"):
    """Build ``f(varK, varT) -> leaf_values[num_leaves, batch]``.

    - ``varK``: [dim, max_loop_num, batch] sampled loop momenta
    - ``varT``: [num_tau, batch] sampled imaginary times

    The values are computed in ``compute_dtype`` and rounded once to
    ``dtype``; ``compute_dtype=dtype`` computes in the storage type, as the
    JAX package does.
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    basis = torch.as_tensor(tables.loop_basis, dtype=compute_dtype, device=device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # the propagators' pairs of times (0-based; 1-based in the tables)
    g_leaf = tables.leaf_type == 1
    pairs, pair_of = np.unique(np.stack([tables.tau_in, tables.tau_out])[:, g_leaf] - 1,
                               axis=1, return_inverse=True)
    pair_idx = np.zeros(tables.num_leaves, np.int64)
    pair_idx[g_leaf] = pair_of.reshape(-1)
    pair_in, pair_out = dev(pairs[0]), dev(pairs[1])
    # (type, order, leaf rows, basis rows, pair rows, scope)
    groups = []
    for t in (1, 2):
        mask = tables.leaf_type == t
        orders = tables.g_order if t == 1 else tables.v_order
        for o in sorted(set(orders[mask].tolist())):
            idx = np.where(mask & (orders == o))[0]
            groups.append((t, int(o), dev(idx), dev(tables.loop_idx[idx]), dev(pair_idx[idx]),
                           f"leaf{'G' if t == 1 else 'V'}{o}"))

    def evaluate(varK, varT) -> torch.Tensor:
        varK = torch.as_tensor(varK, dtype=compute_dtype, device=device)
        varT = torch.as_tensor(varT, dtype=compute_dtype, device=device)
        batch = varK.shape[-1]
        # LoopPool.update as one batched matrix product (pool.jl:69-76)
        with scope("loops"):
            loops = torch.einsum("nl,dlb->dnb", basis, varK)   # [dim, n_basis, batch]
            q2 = torch.sum(loops * loops, dim=0)                # [n_basis, batch]
            if g_leaf.any():
                eps = q2 - kF ** 2
                sp = green_eps_part(eps, beta)                  # [n_basis, batch]
                tau = varT[pair_out] - varT[pair_in]            # [n_pairs, batch]
                sign, tau1 = green_tau_parts(tau, beta)
        out = torch.ones((tables.num_leaves, batch), dtype=dtype, device=device)
        for t, order, gidx, lidx, pidx, name in groups:
            with scope(name):
                if t == 1 and order == 0:
                    vals = torch.exp(-(eps[lidx] * tau1[pidx] + sp[lidx])) * sign[pidx]
                elif t == 1:
                    vals = green_derive_tower(tau[pidx], eps[lidx], beta, order)
                else:
                    vals = interaction_derive(q2[lidx], lam, order,
                                              convention=interaction_convention)
                out[gidx] = vals.to(dtype)
        return out

    return evaluate
