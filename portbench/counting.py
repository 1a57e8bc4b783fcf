"""The least time the card could take for a kernel's work, and the peaks
it is priced at.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the arithmetic rate (NVIDIA's data sheet of the H100 SXM,
dense, at its 700 W limit).  Bytes count each input byte read once and
each output byte written once, whatever a kernel reads again; operations
count what the function needs for these inputs.  Both are computed from
the tables the program built (its lowering and its leaf tables), which are
what the kernels process.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# the most operands a product, or the highest exponent a power, has where the
# level kernel computes it; the program computes any other plainly
KERNEL_MAX_OPERANDS = 4


def level_groups(level) -> List[np.ndarray]:
    """The index tables ``[n_op, arity, count]`` of what one launch of the
    level kernel computes: the level's sum buckets, fused buckets, products
    and powers (a product of k operands is one term of k operands, a power
    of n one term of its row n times)."""
    out = [np.asarray(b.idx)[None] for b in level.sum_buckets]
    out += [np.asarray(b.idx) for b in level.fused]
    out += [np.asarray(p.idx)[:, None] for p in level.prods
            if p.arity <= KERNEL_MAX_OPERANDS]
    out += [np.repeat(np.asarray(p.src)[None, None], p.n, axis=0) for p in level.pows
            if p.n <= KERNEL_MAX_OPERANDS]
    return out


def level_bounds(lowered, batch: int, elsize: int) -> List[Dict[str, float]]:
    """Per level that the kernel runs, its bound in seconds and what sets it:
    bytes (every distinct row the level reads and every row it writes, once
    each) against operations (a multiply per operand and an add per term and
    column, at the float32 rate)."""
    out = []
    for level in lowered.levels:
        groups = level_groups(level)
        if not groups:
            continue
        read = len(np.unique(np.concatenate([g.ravel() for g in groups])))
        written = sum(g.shape[2] for g in groups)
        flops = sum(g.shape[1] * g.shape[2] * (g.shape[0] + 1) for g in groups) * batch
        t_bytes = (read + written) * batch * elsize / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["float32"]
        out.append({"s": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
                    "rows_read": read, "rows_written": written})
    return out


def leaf_operations(tables) -> int:
    """Float64 operations per sample column that the leaf phase needs for
    ``tables`` (the program's ``LeafTables``), one for each add, multiply,
    division, exp and log1p:

    - each momentum (distinct basis row) in use, per component: an add
      between its nonzero entries and a multiply for each entry other than
      +-1; then ``|k|^2``: 3 multiplies, 2 adds;
    - a momentum of a propagator: ``eps = |k|^2 - kF^2``, an add; of a bare
      propagator also ``softplus(-beta eps)``: a multiply, an exp, a log1p
      and an add; of a G counterterm ``sigmoid(-beta eps)``: a multiply, an
      exp, an add and a division;
    - each distinct pair of times: ``tau`` (an add) and ``tau + beta`` (an add);
    - a bare propagator: ``eps tau``, its sum with the softplus, an exp: 3;
      a G counterterm of order n: those 3 and a multiply and an add for each
      of its n Taylor coefficients;
    - a momentum of an interaction: ``q^2 + lam`` and its reciprocal, an
      add and a division; each interaction of order n: n + 1 multiplies.
    """
    lt = np.asarray(tables.leaf_type)
    order = np.where(lt == 1, tables.g_order, tables.v_order)
    basis = np.asarray(tables.loop_basis)
    dim = 3
    ops = 0
    used = np.unique(tables.loop_idx[lt > 0])
    for b in used:
        row = basis[b]
        nz = row != 0
        ops += dim * (max(int(nz.sum()) - 1, 0) + int((nz & (np.abs(row) != 1)).sum())) + 5
        on_row = tables.loop_idx == b
        green = on_row & (lt == 1)
        if green.any():
            ops += 1
            if (green & (order == 0)).any():
                ops += 4
            if (green & (order > 0)).any():
                ops += 4
        if (on_row & (lt == 2)).any():
            ops += 2
    g = lt == 1
    pairs = {(int(a), int(b)) for a, b in zip(tables.tau_in[g], tables.tau_out[g])}
    ops += 2 * len(pairs)
    ops += int((3 + 2 * order[g]).sum())
    ops += int((order[lt == 2] + 1).sum())
    return ops


def leaf_bound(tables, batch: int, sample_bytes: int, elsize: int) -> Dict[str, float]:
    """The leaf phase's bound in seconds: its samples (``sample_bytes`` a
    column) read once and its leaves written once in the storage type,
    against ``leaf_operations`` at the float64 rate."""
    t_bytes = (sample_bytes + len(tables.leaf_type) * elsize) * batch / HBM_BYTES_PER_S
    t_ops = leaf_operations(tables) * batch / PEAK_FLOPS["float64"]
    return {"s": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}
