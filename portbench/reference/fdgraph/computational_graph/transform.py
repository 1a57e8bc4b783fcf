"""Local graph rewrites (in-place and copying variants).

Reference: FeynmanDiagram.jl/src/computational_graph/transform.jl.  These are
host-side IR transforms run before lowering; they never touch device arrays.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

from .graph import Graph, _approx, isequiv
from .operators import PROD, Power, SUM, unary_istrivial


# ---------------------------------------------------------------------------
# replace_subgraph (transform.jl:109-156)
# ---------------------------------------------------------------------------

def replace_subgraph_inplace(g: Graph, w: Graph, m: Graph) -> None:
    """Replace the first subgraph equivalent to ``w`` (modulo id) with ``m``."""
    for node in g.pre_order():
        for i, sub_g in enumerate(node.subgraphs):
            if isequiv(sub_g, w, "id"):
                node.subgraphs[i] = m
                return


def replace_subgraph(g: Graph, w: Graph, m: Graph) -> Graph:
    g_new = copy.deepcopy(g)
    replace_subgraph_inplace(g_new, w, m)
    return g_new


# ---------------------------------------------------------------------------
# open_parenthesis / flatten_prod / flatten_sum (transform.jl:170-340)
# ---------------------------------------------------------------------------

def open_parenthesis_inplace(graph: Graph, memo: Optional[Dict[int, Graph]] = None) -> Graph:
    """Distribute Prod over Sum so the graph becomes Sum-of-Prods."""
    if memo is None:
        memo = {}
    if graph.id in memo:
        return memo[graph.id]
    memo[graph.id] = graph
    if not graph.subgraphs:
        return graph
    children = [open_parenthesis_inplace(sub, memo) for sub in graph.subgraphs]
    newchildren: List[Graph] = []
    newfactors: List[float] = []
    if graph.operator.kind == "sum":
        for child_idx, child in enumerate(children):
            if not child.subgraphs:
                newchildren.append(child)
                newfactors.append(graph.subgraph_factors[child_idx])
            else:
                for gc_idx, grandchild in enumerate(child.subgraphs):
                    newchildren.append(grandchild)
                    newfactors.append(graph.subgraph_factors[child_idx] * child.subgraph_factors[gc_idx])
    elif graph.operator.kind == "prod":
        graph.operator = SUM
        childsub_len = [len(child.subgraphs) for child in children]
        ranges = [range(1, n + 1) if n > 0 else range(0, 1) for n in childsub_len]
        import itertools
        for indices in itertools.product(*ranges):
            newchildnode = Graph([], operator=PROD)
            for child_idx, gc_idx in enumerate(indices):
                child = children[child_idx]
                if gc_idx == 0:  # leaf child
                    newchildnode.subgraphs.append(child)
                    newchildnode.subgraph_factors.append(graph.subgraph_factors[child_idx])
                else:
                    newchildnode.subgraphs.append(child.subgraphs[gc_idx - 1])
                    newchildnode.subgraph_factors.append(
                        graph.subgraph_factors[child_idx] * child.subgraph_factors[gc_idx - 1])
            newchildren.append(newchildnode)
            newfactors.append(1.0)
    graph.subgraphs = newchildren
    graph.subgraph_factors = newfactors
    return graph


def open_parenthesis(graph: Graph) -> Graph:
    return open_parenthesis_inplace(copy.deepcopy(graph))


def flatten_prod_inplace(graph: Graph, memo: Optional[Dict[int, Graph]] = None) -> Graph:
    """Merge nested Prod children into their Prod parents (transform.jl:240-282)."""
    if memo is None:
        memo = {}
    if graph.id in memo:
        return memo[graph.id]
    memo[graph.id] = graph
    if not graph.subgraphs:
        return graph
    children = [flatten_prod_inplace(sub, memo) for sub in graph.subgraphs]
    newchildren: List[Graph] = []
    newfactors: List[float] = []
    if graph.operator.kind == "sum":
        newchildren = children
        newfactors = list(graph.subgraph_factors)
    elif graph.operator.kind == "prod":
        for child_idx, child in enumerate(children):
            if not child.subgraphs or child.operator.kind == "sum":
                newchildren.append(child)
                newfactors.append(graph.subgraph_factors[child_idx])
            else:
                for gc_idx, grandchild in enumerate(child.subgraphs):
                    newchildren.append(grandchild)
                    if gc_idx == 0:
                        newfactors.append(graph.subgraph_factors[child_idx] * child.subgraph_factors[0])
                    else:
                        newfactors.append(child.subgraph_factors[gc_idx])
    else:
        return graph
    graph.subgraphs = newchildren
    graph.subgraph_factors = newfactors
    return graph


def flatten_prod(graph: Graph) -> Graph:
    return flatten_prod_inplace(copy.deepcopy(graph))


def flatten_sum_inplace(graph: Graph, memo: Optional[Dict[int, Graph]] = None) -> Graph:
    """Merge nested Sum children into their Sum parents (transform.jl:299-336)."""
    if memo is None:
        memo = {}
    if graph.id in memo:
        return memo[graph.id]
    memo[graph.id] = graph
    if not graph.subgraphs:
        return graph
    children = [flatten_sum_inplace(sub, memo) for sub in graph.subgraphs]
    newchildren: List[Graph] = []
    newfactors: List[float] = []
    if graph.operator.kind == "sum":
        for child_idx, child in enumerate(children):
            if not child.subgraphs or child.operator.kind == "prod":
                newchildren.append(child)
                newfactors.append(graph.subgraph_factors[child_idx])
            else:
                for gc_idx, grandchild in enumerate(child.subgraphs):
                    newchildren.append(grandchild)
                    newfactors.append(graph.subgraph_factors[child_idx] * child.subgraph_factors[gc_idx])
    elif graph.operator.kind == "prod":
        newchildren = children
        newfactors = list(graph.subgraph_factors)
    else:
        return graph
    graph.subgraphs = newchildren
    graph.subgraph_factors = newfactors
    return graph


def flatten_sum(graph: Graph) -> Graph:
    return flatten_sum_inplace(copy.deepcopy(graph))


# ---------------------------------------------------------------------------
# flatten_chains (transform.jl:354-375)
# ---------------------------------------------------------------------------

def flatten_chains_inplace(g: Graph) -> Graph:
    """Inline trivial unary chains O---O'---...: hoist child factor into parent."""
    for i, sub_g in enumerate(g.subgraphs):
        if unary_istrivial(sub_g.operator) and sub_g.onechild():
            flatten_chains_inplace(sub_g)
            g.subgraph_factors[i] = g.subgraph_factors[i] * sub_g.subgraph_factors[0]
            g.subgraphs[i] = sub_g.eldest()
    return g


def flatten_chains(g: Graph) -> Graph:
    return flatten_chains_inplace(copy.deepcopy(g))


# ---------------------------------------------------------------------------
# remove_zero_valued_subgraphs (transform.jl:388-459)
# ---------------------------------------------------------------------------

def _mask_zero_subgraph_factors(g: Graph) -> List[int]:
    op, fac = g.operator, g.subgraph_factors
    if op.kind == "sum":
        mask = [i for i, f in enumerate(fac) if f != 0]
        return mask if mask else [0]
    if op.kind == "prod":
        for i, f in enumerate(fac):
            if f == 0:
                return [i]
        return list(range(len(fac)))
    if op.kind == "power":
        if op.n >= 0:
            return [0]
        raise ValueError(f"0^{op.n} is illegal!")
    return list(range(len(fac)))


def remove_zero_valued_subgraphs_inplace(g: Graph) -> Graph:
    from .tree_properties import has_zero_subfactors
    if g.isleaf() or g.isbranch():  # retain at least one subgraph
        return g
    subg = list(g.subgraphs)
    subg_fac = list(g.subgraph_factors)
    for i, sub_g in enumerate(subg):
        if sub_g.isleaf():
            continue
        if has_zero_subfactors(sub_g):
            subg_fac[i] = 0.0
    g.subgraphs = subg
    g.subgraph_factors = subg_fac
    mask = _mask_zero_subgraph_factors(g)
    g.subgraphs = [subg[i] for i in mask]
    g.subgraph_factors = [subg_fac[i] for i in mask]
    return g


def remove_zero_valued_subgraphs(g: Graph) -> Graph:
    return remove_zero_valued_subgraphs_inplace(copy.deepcopy(g))


# ---------------------------------------------------------------------------
# merge_linear_combination / merge_multi_product (transform.jl:472-579)
# ---------------------------------------------------------------------------

def merge_linear_combination_inplace(g: Graph, identity_only: bool = False) -> Graph:
    """3*g1 + 5*g2 + 7*g1 -> 10*g1 + 5*g2 (match modulo id).

    ``identity_only`` skips the O(k²) pairwise isequiv scan and merges only
    identical child objects — exhaustive on a hash-consed DAG, where every
    isequiv-equal pair is already the same object (the optimizer pipeline
    passes this after ``remove_duplicated_nodes_inplace``).
    """
    if g.operator.kind != "sum":
        return g
    # group identical child OBJECTS first (O(k)); on a hash-consed DAG this
    # already captures every equivalence, leaving the pairwise isequiv scan
    # below with nothing to do
    by_obj: dict = {}
    order: List[int] = []
    for s, f in zip(g.subgraphs, g.subgraph_factors):
        key = id(s)
        if key in by_obj:
            by_obj[key][1] += f
        else:
            by_obj[key] = [s, f]
            order.append(key)
    subg = [by_obj[k][0] for k in order]
    subg_fac = [by_obj[k][1] for k in order]

    if identity_only:
        g.subgraphs = subg
        g.subgraph_factors = subg_fac
        return g

    added = [False] * len(subg)
    merged_subg: List[Graph] = []
    merged_fac: List[float] = []
    for i in range(len(subg)):
        if added[i]:
            continue
        merged_subg.append(subg[i])
        merged_fac.append(subg_fac[i])
        added[i] = True
        k = len(merged_fac) - 1
        for j in range(i + 1, len(subg)):
            if not added[j] and isequiv(subg[i], subg[j], "id"):
                added[j] = True
                merged_fac[k] += subg_fac[j]
    g.subgraphs = merged_subg
    g.subgraph_factors = merged_fac
    return g


def merge_linear_combination(g: Graph) -> Graph:
    return merge_linear_combination_inplace(copy.deepcopy(g))


def merge_multi_product_inplace(g: Graph) -> Graph:
    """Merge repeated subgraphs of a Prod into Power nodes."""
    if g.operator.kind != "prod":
        return g
    unique_graphs: List[Graph] = []
    unique_factors: List[float] = []
    repeated_counts: List[int] = []
    for idx, subg in enumerate(g.subgraphs):
        loc = None
        for i, ug in enumerate(unique_graphs):
            if subg == ug:
                loc = i
                break
        if loc is None:
            unique_graphs.append(subg)
            unique_factors.append(g.subgraph_factors[idx])
            repeated_counts.append(1)
        else:
            unique_factors[loc] *= g.subgraph_factors[idx]
            repeated_counts[loc] += 1
    if len(unique_factors) == 1 and repeated_counts[0] > 1:
        g.subgraphs = unique_graphs
        g.subgraph_factors = unique_factors
        g.operator = Power(repeated_counts[0])
    else:
        _subgraphs: List[Graph] = []
        for idx, sub in enumerate(unique_graphs):
            if repeated_counts[idx] == 1:
                _subgraphs.append(sub)
            else:
                _subgraphs.append(Graph([sub], operator=Power(repeated_counts[idx])))
        g.subgraphs = _subgraphs
        g.subgraph_factors = unique_factors
        g.operator = PROD
    return g


def merge_multi_product(g: Graph) -> Graph:
    return merge_multi_product_inplace(copy.deepcopy(g))
