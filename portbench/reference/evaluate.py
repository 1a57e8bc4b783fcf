"""The plain reference: a diagram series' roots in float64, by depth.

The roots are graphs of the frozen front end (``fdgraph``): every node is a
sum ``sum_i f_i c_i``, a product ``prod_i (f_i c_i)`` or a power ``f c^n``
of its children ``c_i``, and a leaf is a propagator or an interaction
(``physics``) or a constant.  ``plan_of`` numbers the distinct nodes once;
``evaluate`` computes every node of one depth at a time, over blocks of
sample columns, in float64 with plain PyTorch: gathers, products and
``index_add_``, no matrix product, nothing of the program.  It does not
lower, merge common subexpressions or reuse rows: each node of the graph
keeps its own row, which is what the program's lowering has to reproduce.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import physics

COLUMN_BLOCK_BYTES = 1 << 30   # the float64 node table of one block of columns


@dataclass
class Plan:
    """The numbered nodes of a series: the leaves first (rows 0 .. L-1),
    per leaf its kind (1 = propagator, 2 = interaction, 0 = constant), its
    momentum over the loops, its times, its order and, for a constant, its
    value; the ``steps`` of each depth; ``roots``, the roots' rows."""
    n_nodes: int
    n_loop: int
    leaf_kind: np.ndarray
    leaf_basis: np.ndarray
    leaf_tau: np.ndarray
    leaf_order: np.ndarray
    leaf_const: np.ndarray
    roots: np.ndarray
    steps: List[list] = field(default_factory=list)


def _post_order(roots: Sequence) -> list:
    """Each distinct node once, children before parents."""
    seen, order = set(), []
    for root in roots:
        stack = [(root, False)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
            elif node.id not in seen:
                seen.add(node.id)
                stack.append((node, True))
                stack.extend((c, False) for c in node.subgraphs if c.id not in seen)
    return order


def plan_of(roots: Sequence, n_loop: int, green_type, interaction_type) -> Plan:
    """Number the nodes of ``roots`` and group them by depth and operator.
    ``green_type`` and ``interaction_type`` are the front end's id classes
    of a bare propagator and a bare interaction."""
    nodes = _post_order(roots)
    leaves = [n for n in nodes if not n.subgraphs]
    inner = [n for n in nodes if n.subgraphs]
    row: Dict[int, int] = {n.id: i for i, n in enumerate(leaves + inner)}
    kind = np.zeros(len(leaves), np.int64)
    basis = np.zeros((len(leaves), n_loop))
    tau = np.zeros((len(leaves), 2), np.int64)
    order = np.zeros(len(leaves), np.int64)
    const = np.zeros(len(leaves))
    for i, leaf in enumerate(leaves):
        props = leaf.properties
        if leaf.operator.kind == "unitary":
            const[i] = leaf.weight
            continue
        if isinstance(props, green_type):
            kind[i], order[i] = 1, leaf.orders[0]
        elif isinstance(props, interaction_type):
            kind[i], order[i] = 2, leaf.orders[1]
        else:
            raise ValueError(f"a leaf of {type(props).__name__}, which the reference lacks")
        k = np.asarray(props.extK, float)
        basis[i, :len(k)] = k
        tau[i] = props.extT[0] - 1, props.extT[1] - 1
    depth: Dict[int, int] = {}
    for n in nodes:
        depth[n.id] = 1 + max((depth[c.id] for c in n.subgraphs), default=-1)
    by_depth: Dict[int, list] = {}
    for n in inner:
        by_depth.setdefault(depth[n.id], []).append(n)
    steps = []
    for d in sorted(by_depth):
        group = by_depth[d]
        sums = [n for n in group if n.operator.kind == "sum"]
        prods = [n for n in group if n.operator.kind == "prod"]
        pows = [n for n in group if n.operator.kind == "power"]
        if len(sums) + len(prods) + len(pows) != len(group):
            raise ValueError("a node of an operator the reference lacks")
        step = []
        if sums:
            local = np.concatenate([[i] * len(n.subgraphs) for i, n in enumerate(sums)])
            src = np.concatenate([[row[c.id] for c in n.subgraphs] for n in sums])
            fac = np.concatenate([n.subgraph_factors for n in sums]).astype(float)
            step.append(("sum", np.asarray([row[n.id] for n in sums]), local, src, fac))
        for arity in sorted({len(n.subgraphs) for n in prods}):
            part = [n for n in prods if len(n.subgraphs) == arity]
            step.append(("prod", np.asarray([row[n.id] for n in part]),
                         np.asarray([[row[c.id] for c in n.subgraphs] for n in part]),
                         np.asarray([np.prod(n.subgraph_factors) for n in part], float)))
        for n_pow in sorted({n.operator.n for n in pows}):
            part = [n for n in pows if n.operator.n == n_pow]
            step.append(("pow", np.asarray([row[n.id] for n in part]),
                         np.asarray([row[n.subgraphs[0].id] for n in part]),
                         np.asarray([n.subgraph_factors[0] for n in part], float), n_pow))
        steps.append(step)
    return Plan(len(nodes), n_loop, kind, basis, tau, order, const,
                np.asarray([row[r.id] for r in roots]), steps)


def _leaf_values(plan: Plan, varK: torch.Tensor, varT: torch.Tensor, *, beta: float,
                 kF: float, lam: float, convention: str) -> torch.Tensor:
    dev = varK.device
    basis = torch.as_tensor(plan.leaf_basis, dtype=torch.float64, device=dev)
    q2 = sum((basis @ varK[d]) ** 2 for d in range(varK.shape[0]))
    out = torch.empty_like(q2)
    const = plan.leaf_kind == 0
    if const.any():
        idx = torch.as_tensor(np.flatnonzero(const), device=dev)
        out[idx] = torch.as_tensor(plan.leaf_const[const], dtype=torch.float64,
                                   device=dev)[:, None].expand(-1, q2.shape[1])
    for kind in (1, 2):
        for order in np.unique(plan.leaf_order[plan.leaf_kind == kind]):
            sel = np.flatnonzero((plan.leaf_kind == kind) & (plan.leaf_order == order))
            idx = torch.as_tensor(sel, device=dev)
            if kind == 1:
                t_in = torch.as_tensor(plan.leaf_tau[sel, 0], device=dev)
                t_out = torch.as_tensor(plan.leaf_tau[sel, 1], device=dev)
                out[idx] = physics.green(varT[t_out] - varT[t_in], q2[idx] - kF ** 2, beta,
                                         int(order))
            else:
                out[idx] = physics.interaction(q2[idx], lam, int(order), convention)
    return out


def evaluate(plan: Plan, varK: torch.Tensor, varT: torch.Tensor, *, beta: float, kF: float,
             lam: float, convention: str = "lambda_power") -> torch.Tensor:
    """The roots ``[R, batch]`` in float64 for the samples ``varK`` [dim,
    n_loop, batch] and ``varT`` [num_tau, batch] (any float type, widened),
    on their device, in blocks of columns."""
    varK = varK.to(torch.float64)
    varT = varT.to(torch.float64)
    batch = varK.shape[-1]
    block = max(1, min(batch, COLUMN_BLOCK_BYTES // (8 * max(plan.n_nodes, 1))))
    dev = varK.device
    steps = [[tuple(torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray) else a
                    for a in op) for op in step] for step in plan.steps]
    roots = torch.as_tensor(plan.roots, device=dev)
    out = torch.empty((len(plan.roots), batch), dtype=torch.float64, device=dev)
    for c0 in range(0, batch, block):
        c1 = min(batch, c0 + block)
        vals = torch.empty((plan.n_nodes, c1 - c0), dtype=torch.float64, device=dev)
        vals[:len(plan.leaf_kind)] = _leaf_values(plan, varK[..., c0:c1], varT[:, c0:c1],
                                                  beta=beta, kF=kF, lam=lam,
                                                  convention=convention)
        for step in steps:
            for op in step:
                if op[0] == "sum":
                    _, dst, local, src, fac = op
                    acc = vals.new_zeros((len(dst), c1 - c0))
                    acc.index_add_(0, local, vals[src] * fac[:, None])
                    vals[dst] = acc
                elif op[0] == "prod":
                    _, dst, src, fac = op
                    prod = vals[src[:, 0]] * fac[:, None]
                    for j in range(1, src.shape[1]):
                        prod = prod * vals[src[:, j]]
                    vals[dst] = prod
                else:
                    _, dst, src, fac, n_pow = op
                    vals[dst] = vals[src] ** n_pow * fac[:, None]
        out[:, c0:c1] = vals[roots]
    return out
