"""Whole-DAG optimization passes.

Reference: FeynmanDiagram.jl/src/computational_graph/optimize.jl.  The
duplicate-node elimination replaces the reference's O(N^2) pairwise
``isequiv`` scan with O(N) structural hash-consing — same equivalence
relation (ignore id/name/weight, children matched as factor-weighted
multisets), dramatically faster on graphs with 1e5+ nodes, which is the
regime the TPU lowering targets.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.profiling import phased
from .graph import Graph
from .transform import (flatten_chains_inplace, merge_linear_combination_inplace,
                        merge_multi_product_inplace, remove_zero_valued_subgraphs_inplace)


@phased("optimize_inplace")
def optimize_inplace(graphs: Sequence[Graph], *, level: int = 0, verbose: int = 0,
                     normalize=None) -> Optional[Sequence[Graph]]:
    """In-place optimization pipeline (optimize.jl:16-36).

    level == 0: deduplicate leaves only; level > 0: hash-cons all nodes.
    Then flatten trivial unary chains, merge linear combinations, and remove
    zero-valued subgraphs.
    """
    if not graphs:
        return None
    # flatten BEFORE hash-consing: chain flattening can turn structurally
    # distinct nodes into equal ones, so running it after dedup would break
    # the identity-only invariant the merge pass relies on (every
    # isequiv-equal pair is the same object) — ADVICE r3
    flatten_all_chains_inplace(graphs, verbose=verbose)
    if level > 0:
        remove_duplicated_nodes_inplace(graphs, verbose=verbose)
    else:
        remove_duplicated_leaves_inplace(graphs, verbose=verbose, normalize=normalize)
    # after full hash-consing every isequiv-equal pair is the same object,
    # so the pairwise scan inside the merge pass is redundant
    merge_all_linear_combinations_inplace(graphs, verbose=verbose,
                                          identity_only=level > 0)
    remove_all_zero_valued_subgraphs_inplace(graphs, verbose=verbose)
    return graphs


def optimize(graphs: Sequence[Graph], *, level: int = 0, verbose: int = 0, normalize=None):
    graphs_new = copy.deepcopy(list(graphs))
    optimize_inplace(graphs_new, level=level, verbose=verbose, normalize=normalize)
    return graphs_new


# ---------------------------------------------------------------------------
# DAG-wide passes (memoized post-order over unique nodes)
# ---------------------------------------------------------------------------

def _iter_unique_postorder(graphs: Sequence[Graph]):
    """Post-order over the union DAG of ``graphs`` with ONE shared visited
    set, so shared subgraphs are yielded once across all roots (the per-root
    ``g.post_order()`` would re-walk the whole shared DAG per root —
    O(roots * nodes) on parquet outputs with hundreds of roots)."""
    visited = set()  # object identity: deepcopied graphs may share uids
    for g in graphs:
        stack: List[Tuple[Graph, bool]] = [(g, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                yield node
                continue
            if id(node) in visited:
                continue
            visited.add(id(node))
            stack.append((node, True))
            for sub in reversed(node.subgraphs):
                if id(sub) not in visited:
                    stack.append((sub, False))


def _for_each_node_postorder(graphs: Sequence[Graph], fn) -> None:
    for node in _iter_unique_postorder(graphs):
        fn(node)


def flatten_all_chains_inplace(graphs, *, verbose: int = 0):
    if isinstance(graphs, Graph):
        graphs = [graphs]
    _for_each_node_postorder(graphs, flatten_chains_inplace)
    return graphs


def merge_all_linear_combinations_inplace(graphs, *, verbose: int = 0,
                                          identity_only: bool = False):
    if isinstance(graphs, Graph):
        graphs = [graphs]
    _for_each_node_postorder(
        graphs, lambda n: merge_linear_combination_inplace(n, identity_only))
    return graphs


def merge_all_multi_products_inplace(graphs, *, verbose: int = 0):
    if isinstance(graphs, Graph):
        graphs = [graphs]
    _for_each_node_postorder(graphs, merge_multi_product_inplace)
    return graphs


def remove_all_zero_valued_subgraphs_inplace(graphs, *, verbose: int = 0):
    if isinstance(graphs, Graph):
        graphs = [graphs]
    _for_each_node_postorder(graphs, remove_zero_valued_subgraphs_inplace)
    return graphs


# ---------------------------------------------------------------------------
# structural hash-consing (replaces unique_nodes! / remove_duplicated_*)
# ---------------------------------------------------------------------------

def _factor_key(f):
    if isinstance(f, complex):
        return (f.real, f.imag)
    return (float(f), 0.0)


def _prop_key(properties, fallback: int):
    if properties is None:
        return None
    try:
        hash(properties)
        return properties
    except TypeError:
        return ("__unhashable__", fallback)


def structural_key(node: Graph, child_key_ids: Sequence[int]) -> Tuple:
    """Canonical key implementing isequiv(a, b, :id, :name, :weight).

    Children enter as a multiset of (factor, canonical-child) pairs; Sum and
    Prod are commutative in the reference equivalence.
    """
    pairs = sorted(zip((_factor_key(f) for f in node.subgraph_factors), child_key_ids))
    return (type(node).__name__, node.operator, tuple(node.orders),
            _prop_key(node.properties, node.id), tuple(pairs))


def unique_nodes(nodes: Sequence[Graph], mapping: Optional[Dict[int, Graph]] = None) -> Dict[int, Graph]:
    """Map each node id to a canonical equivalent node (leaves only use-case).

    Reference: optimize.jl:255-277 (O(N^2) scan) — here O(N) via hashing.
    """
    if mapping is None:
        mapping = {}
    canon: Dict[Tuple, Graph] = {}
    for g in mapping.values():
        canon.setdefault(structural_key(g, [sub.id for sub in g.subgraphs]), g)
    for g in nodes:
        key = structural_key(g, [sub.id for sub in g.subgraphs])
        if key in canon:
            mapping[g.id] = canon[key]
        else:
            canon[key] = g
            mapping[g.id] = g
    return mapping


def remove_duplicated_leaves_inplace(graphs: Sequence[Graph], *, verbose: int = 0,
                                     normalize=None) -> Sequence[Graph]:
    """Merge equivalent leaf nodes across all graphs (optimize.jl:289-317)."""
    leaves: List[Graph] = []
    seen = set()
    internal: List[Graph] = []
    for node in _iter_unique_postorder(graphs):
        if node.isleaf():
            if node.id not in seen:
                seen.add(node.id)
                leaves.append(node)
        else:
            internal.append(node)
    if normalize is not None:
        for leaf in leaves:
            normalize(leaf.id)
    leaves.sort(key=lambda x: x.id)
    mapping = unique_nodes(leaves)
    for n in internal:
        for si, sub_g in enumerate(n.subgraphs):
            if sub_g.isleaf():
                n.subgraphs[si] = mapping[sub_g.id]
    return graphs


def remove_duplicated_nodes_inplace(graphs, *, verbose: int = 0):
    """Full hash-consing of the DAG: merge every equivalent internal node.

    Reference: optimize.jl:319-390, with the pairwise isequiv scan replaced
    by bottom-up structural hashing.
    """
    if isinstance(graphs, Graph):
        graphs = [graphs]
    canon: Dict[Tuple, Graph] = {}
    canonical_of: Dict[int, Graph] = {}

    for node in _iter_unique_postorder(graphs):
        if node.id in canonical_of:
            continue
        # rewire children to canonical representatives first
        for i, sub in enumerate(node.subgraphs):
            node.subgraphs[i] = canonical_of[sub.id]
        key = structural_key(node, [sub.id for sub in node.subgraphs])
        rep = canon.get(key)
        if rep is None:
            canon[key] = node
            canonical_of[node.id] = node
        else:
            canonical_of[node.id] = rep
    # rewire root-level references
    result = [canonical_of[g.id] for g in graphs]
    # in-place contract: mutate the caller's list when possible
    try:
        for i, r in enumerate(result):
            graphs[i] = r
    except TypeError:
        pass
    return graphs


def burn_from_targetleaves_inplace(graphs: Sequence[Graph], targetleaves_id: Sequence[int],
                                   *, verbose: int = 0) -> Optional[int]:
    """Remove all nodes connected to target leaves via Prod operators.

    Burnt graphs become zero-weight Unitary constants; returns the id of the
    replacement constant if any graph burnt completely, else None.
    Reference: optimize.jl:405-456.
    """
    from .graph import constant_graph, linear_combination
    from .operators import UNITARY

    targets = set(targetleaves_id)
    graphs_sum = linear_combination(list(graphs), [1.0] * len(graphs))

    for leaf in graphs_sum.leaves():
        if leaf.id in targets:
            leaf.name = "BURNING"

    for node in graphs_sum.post_order():
        if any(x.name == "BURNING" for x in node.subgraphs):
            if node.operator.kind in ("prod", "power"):
                node.subgraphs = []
                node.subgraph_factors = []
                node.name = "BURNING"
            else:
                _subgraphs = []
                _factors = []
                for i, subg in enumerate(node.subgraphs):
                    if subg.name != "BURNING":
                        _subgraphs.append(subg)
                        _factors.append(node.subgraph_factors[i])
                node.subgraphs = _subgraphs
                node.subgraph_factors = _factors
                if not _factors:
                    node.name = "BURNING"

    g_c1 = constant_graph(1.0)
    has_c0 = False
    for g in graphs:
        if g.name == "BURNING":
            has_c0 = True
            g.id = g_c1.id
            g.operator = UNITARY
            g.subgraphs = []
            g.subgraph_factors = []
            g.weight = 0.0
    return g_c1.id if has_c0 else None
