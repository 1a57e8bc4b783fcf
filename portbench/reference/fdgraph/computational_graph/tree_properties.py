"""Predicates and cost metrics on graphs.

Reference: FeynmanDiagram.jl/src/computational_graph/tree_properties.jl.
The [adds, muls] op-count metric is the package's graph "cost model": it
quantifies optimizer and AD-sharing wins, and doubles as the FLOP estimate
for the lowered TPU kernels (2 * count * batch per MC evaluation).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Union

from .graph import Graph


def haschildren(g: Graph) -> bool:
    return g.haschildren()


def onechild(g: Graph) -> bool:
    return g.onechild()


def isleaf(g: Graph) -> bool:
    return g.isleaf()


def isbranch(g: Graph) -> bool:
    return g.isbranch()


def ischain(g: Graph) -> bool:
    return g.ischain()


def eldest(g: Graph) -> Graph:
    return g.eldest()


def has_zero_subfactors(g: Graph) -> bool:
    """Does the node trivially evaluate to zero from its subgraph factors?

    Sum: all factors zero; Prod: any factor zero; Power: first factor zero.
    Leaves return False by convention.  Reference: tree_properties.jl:99-117.
    """
    if g.isleaf():
        return False
    op = g.operator
    if op.kind == "sum":
        return all(f == 0 for f in g.subgraph_factors)
    if op.kind == "prod":
        return any(f == 0 for f in g.subgraph_factors)
    if op.kind == "power":
        return g.subgraph_factors[0] == 0
    return False


def count_leaves(g: Union[Graph, Sequence[Graph]]) -> int:
    graphs = [g] if isinstance(g, Graph) else list(g)
    seen = set()
    for graph in graphs:
        for leaf in graph.leaves():
            seen.add(leaf.id)
    return len(seen)


def count_operation(g) -> List[int]:
    """Total [#adds, #muls] over unique nodes (id-deduplicated).

    Accepts a Graph, a sequence of Graphs or TaylorSeries, a TaylorSeries
    (counted over its coefficient graphs, utility.jl:423-440), or a dict of
    order -> Graph(s).  Reference: tree_properties.jl:165-237.
    """
    if g is None:
        return [0, 0]
    if hasattr(g, "coeffs"):  # TaylorSeries
        return count_operation(g.coeffs)
    if isinstance(g, (list, tuple)) and g and hasattr(g[0], "coeffs"):
        out = []
        for s in g:
            out.extend(v for v in s.coeffs.values() if isinstance(v, Graph))
        return count_operation(out)
    if isinstance(g, Graph):
        graphs: Iterable[Graph] = [g]
    elif isinstance(g, dict):
        graphs = []
        for v in g.values():
            if isinstance(v, Graph):
                graphs.append(v)
            elif isinstance(v, (int, float, complex)):
                continue
            else:
                graphs.extend(v)
    elif isinstance(g, (int, float, complex)):
        return [0, 0]
    else:
        graphs = list(g)
    visited = set()
    totalsum = 0
    totalprod = 0
    for graph in graphs:
        for node in graph.pre_order():
            if node.id in visited:
                continue
            visited.add(node.id)
            if node.subgraphs:
                if node.operator.kind == "prod":
                    totalprod += len(node.subgraphs) - 1
                elif node.operator.kind == "sum":
                    totalsum += len(node.subgraphs) - 1
    return [totalsum, totalprod]


def count_expanded_operation(g: Graph) -> List[int]:
    """Op count of the fully expanded (unshared, no parentheses) expression.

    Reference: tree_properties.jl:247-274.  Memoized over the DAG.
    """
    memo: Dict[int, List[int]] = {}

    def rec(node: Graph) -> List[int]:
        cached = memo.get(node.id)
        if cached is not None:
            return cached
        if node.isleaf():
            memo[node.id] = [0, 0]
            return memo[node.id]
        sub = [rec(s) for s in node.subgraphs]
        n = len(sub)
        if node.operator.kind == "sum":
            totalsum = sum(s[0] for s in sub) + n - 1
            totalprod = sum(s[1] for s in sub)
        elif node.operator.kind == "prod":
            totalsum = 1
            for s in sub:
                totalsum *= s[0] + 1
            totalsum -= 1
            innerprod = 0
            for i in range(n):
                term = sub[i][1]
                for j in range(n):
                    if j != i:
                        term *= sub[j][0] + 1
                innerprod += term
            totalprod = innerprod + (totalsum + 1) * (n - 1)
        else:
            totalsum, totalprod = 0, 0
        memo[node.id] = [totalsum, totalprod]
        return memo[node.id]

    return rec(g)
