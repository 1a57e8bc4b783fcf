"""Interpreted post-order evaluation of a graph (the semantic ground truth).

This is the host-side reference evaluator; the production path lowers graphs
to array form and evaluates batches on TPU (``feynmandiagram_tpu_torch.ops``).  The
two must agree to float tolerance on every node — that equivalence is the
core correctness test of the lowering.

Reference: FeynmanDiagram.jl/src/computational_graph/eval.jl:15-66.
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Sequence

from .graph import Graph


def apply_op(node: Graph) -> float:
    op = node.operator
    if op.kind == "sum":
        return sum(g.weight * f for g, f in zip(node.subgraphs, node.subgraph_factors))
    if op.kind == "prod":
        result = 1.0
        for g, f in zip(node.subgraphs, node.subgraph_factors):
            result *= g.weight * f
        return result
    if op.kind == "power":
        return (node.subgraphs[0].weight ** op.n) * node.subgraph_factors[0]
    if op.kind == "unitary":
        return node.weight
    raise ValueError(f"unknown operator {op}")


def eval_graph(g: Graph, leafmap: Optional[Dict[int, int]] = None,
               leaf: Optional[Sequence[float]] = None, *,
               inherit: bool = False, randseed: int = -1) -> float:
    """Evaluate ``g`` bottom-up, writing each node's ``weight`` in place.

    - With no ``leafmap``: leaves evaluate to 1.0 (or to ``random()`` values
      when ``randseed > 0``) — the convention used by diagram-count oracles.
    - With ``leafmap``: leaf ``weight = leaf[leafmap[leaf.id]]``.
    - ``inherit=True`` keeps existing leaf weights.

    Returns the root weight.
    """
    rng = random.Random(randseed) if randseed > 0 else None
    for node in g.post_order():
        if node.isleaf():
            if node.operator.kind == "unitary" or inherit:
                continue
            if leafmap:
                node.weight = leaf[leafmap[node.id]]
            else:
                node.weight = rng.random() if rng is not None else 1.0
        else:
            node.weight = apply_op(node)
    return g.weight


def eval_graphs(graphs: Sequence[Graph], leafmap: Optional[Dict[int, int]] = None,
                leaf: Optional[Sequence[float]] = None, **kw) -> list:
    return [eval_graph(g, leafmap, leaf, **kw) for g in graphs]
