"""Vectorized leaf evaluation: SoA leaf tables -> batched leaf values.

Port of ``feynmandiagram_tpu/ops/leaf_eval.py`` in the flat layout.
``LeafTables`` and ``leaf_tables_from_lowered`` are the reference's numpy
code, re-homed here because the original file imports jax.  The evaluator
runs, per call:

1. ``loops = einsum(basis, varK)``, the LoopPool update as one matrix
   product, and ``q2 = |loops|^2`` per basis row;
2. one vectorized physics call per (leaf type, derivative order) group,
   scattered into a ``[num_leaves, batch]`` buffer initialised to ones.

The group index tables are built and uploaded to the device once.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List

import numpy as np
import torch

from ..frontends import BareGreenId, BareInteractionId
from ..models.free_fermion import green_derive_tower
from ..models.yukawa import interaction_derive
from .dtypes import default_device, default_dtype


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
    """
    n_input = lowered.num_leaves - len(lowered.const_slots)
    leaf_type = np.zeros(n_input, np.int32)
    g_order = np.zeros(n_input, np.int32)
    v_order = np.zeros(n_input, np.int32)
    tau_in = np.ones(n_input, np.int32)
    tau_out = np.ones(n_input, np.int32)
    loop_idx = np.zeros(n_input, np.int32)
    loop_basis: List[np.ndarray] = []

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
        for bi, b in enumerate(loop_basis):
            if np.allclose(b, k, rtol=1.49e-8):
                loop_idx[slot] = bi
                break
        else:
            loop_basis.append(k)
            loop_idx[slot] = len(loop_basis) - 1
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
                      np.stack(loop_basis) if loop_basis else np.zeros((0, max_loop_num)))


def make_leaf_evaluator(tables: LeafTables, *, beta: float, kF: float, lam: float,
                        device=None, dtype=None,
                        interaction_convention: str = "lambda_power"):
    """Build ``f(varK, varT) -> leaf_values[num_leaves, batch]``.

    - ``varK``: [dim, max_loop_num, batch] sampled loop momenta
    - ``varT``: [num_tau, batch] sampled imaginary times
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    basis = torch.as_tensor(tables.loop_basis, dtype=dtype, device=device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # (type, order, leaf rows, basis rows, tau_in rows, tau_out rows); tau
    # indices in the tables are 1-based
    groups = []
    for t in (1, 2):
        mask = tables.leaf_type == t
        orders = tables.g_order if t == 1 else tables.v_order
        for o in sorted(set(orders[mask].tolist())):
            idx = np.where(mask & (orders == o))[0]
            groups.append((t, int(o), dev(idx), dev(tables.loop_idx[idx]),
                           dev(tables.tau_in[idx] - 1), dev(tables.tau_out[idx] - 1)))

    def evaluate(varK, varT) -> torch.Tensor:
        varK = torch.as_tensor(varK, dtype=dtype, device=device)
        varT = torch.as_tensor(varT, dtype=dtype, device=device)
        batch = varK.shape[-1]
        # LoopPool.update as one batched matrix product (pool.jl:69-76)
        loops = torch.einsum("nl,dlb->dnb", basis, varK)   # [dim, n_basis, batch]
        q2 = torch.sum(loops * loops, dim=0)                # [n_basis, batch]
        out = torch.ones((tables.num_leaves, batch), dtype=dtype, device=device)
        for t, order, gidx, lidx, t_in, t_out in groups:
            q2_g = q2[lidx]
            if t == 1:
                tau = varT[t_out] - varT[t_in]
                vals = green_derive_tower(tau, q2_g - kF ** 2, beta, order)
            else:
                vals = interaction_derive(q2_g, lam, order,
                                          convention=interaction_convention)
            out[gidx] = vals.to(dtype)
        return out

    return evaluate
