"""Row grouping (mergeby) and momentum/τ rebasing of cached graphs.

The reference uses DataFrames; here diagram tables are plain lists of dicts
with a ``diagram`` key plus grouping fields.  Reference:
FeynmanDiagram.jl/src/frontend/parquet/operation.jl.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import DiagPara
from ...computational_graph import Graph, SUM, uid
from ..diagram_id import (GenericId, GreenId, PolarId, PropagatorId, SigmaId,
                          Ver3Id, Ver4Id, reconstruct)


def _merge_diag(group: List[dict], diag_id, operator, name: str) -> Graph:
    """(operation.jl:24-36)."""
    if len(group) == 1:
        existing = group[0]["diagram"]
        if isinstance(diag_id, GenericId) or type(diag_id) is type(existing.properties):
            return existing
    return Graph([row["diagram"] for row in group], operator=operator,
                 properties=diag_id, name=name)


def mergeby(rows: List[dict], fields: Sequence[str] = (), *, operator=SUM,
            name: str = "", getid: Optional[Callable] = None) -> List[dict]:
    """Group rows by ``fields`` and merge each group's diagrams into one node.

    Returns a new list of rows carrying the group key fields + ``diagram``.
    Groups are sorted by key, as in the reference (operation.jl:88-106).
    """
    if not rows:
        return rows
    if getid is None:
        getid = lambda group: GenericId(group[0]["diagram"].properties.para,
                                        tuple(group[0][f] for f in fields))
    groups: Dict[tuple, List[dict]] = {}
    for row in rows:
        key = tuple(row[f] for f in fields)
        groups.setdefault(key, []).append(row)
    out = []
    for key in sorted(groups.keys(), key=_sort_key):
        group = groups[key]
        diag = _merge_diag(group, getid(group), operator, name)
        newrow = {f: v for f, v in zip(fields, key)}
        newrow["diagram"] = diag
        out.append(newrow)
    return out


def _sort_key(key: tuple):
    return tuple((int(k) if hasattr(k, "__int__") and not isinstance(k, tuple) else k)
                 for k in key)


def merge_graphs(diags: List[Graph], *, operator=SUM, name: str = "",
                 getid: Optional[Callable] = None) -> List[Graph]:
    """Merge a plain list of graphs into one Sum node (operation.jl:138-155)."""
    if not diags:
        return diags
    if getid is None:
        diag_id = GenericId(diags[0].properties.para)
    else:
        diag_id = getid(diags)
    if len(diags) == 1 and (isinstance(diag_id, GenericId)
                            or type(diag_id) is type(diags[0].properties)):
        return diags
    return [Graph(diags, operator=operator, properties=diag_id, name=name)]


def update_extKT_inplace(diags: Sequence[Graph], para: DiagPara,
                         legK: Sequence[np.ndarray], extra_loop_idx: Optional[int] = None
                         ) -> None:
    """Rebase external momenta (extK) and shift external times (extT) of all
    nodes in ``diags`` in place.

    ``legK``: new external momentum basis [left-in, left-out, right-in,
    right-out]; ``extra_loop_idx`` is the 1-based index of an extra loop slot
    in the old basis, moved to the end.  Reference: operation.jl:170-237.
    """
    visited = set()
    tau_idx = para.firstTauIdx
    len_extK = len(legK[0])
    extK = [np.asarray(k, float) for k in legK[:-1]]
    extK_mat = np.asarray(extK)
    indices = list(range(len_extK))
    # order external legs by sparsity, then pick an independent old-basis
    # slot for each (operation.jl:217-223) — depends only on extK, so it is
    # computed once per call, not once per node
    permu = sorted(range(len(extK)),
                   key=lambda i: int(np.count_nonzero(extK[i])))
    idx_independent: List[int] = []
    for i in permu:
        j = next(idx for idx in indices
                 if idx not in idx_independent and extK[i][idx] != 0)
        idx_independent.append(j)
    swap_pairs = list(zip(permu, idx_independent))
    idx_inner = [idx for idx in indices if idx not in idx_independent]

    for graph in diags:
        tau_shift = tau_idx - graph.properties.extT[0]
        for node in graph.pre_order():
            if id(node) in visited:
                continue
            node.id = uid()
            visited.add(id(node))
            prop = node.properties
            if not (hasattr(prop, "extK") and hasattr(prop, "extT")):
                continue
            if isinstance(prop, (Ver4Id, Ver3Id)):
                newK = tuple(tuple(legK[i][:len_extK]) for i in range(len(prop.extK)))
                updates = {"extK": newK, "para": para}
                if tau_shift != 0:
                    updates["extT"] = tuple(t + tau_shift for t in prop.extT)
                node.properties = reconstruct(prop, **updates)
            elif isinstance(prop, (PropagatorId, GreenId, SigmaId, PolarId)):
                K = np.zeros(len_extK)
                old = np.asarray(prop.extK, float)
                n_copy = min(len(old), len_extK)
                K[:n_copy] = old[:n_copy]
                if len(old) < len_extK and extra_loop_idx is not None:
                    K[-1] = K[extra_loop_idx - 1]
                    K[extra_loop_idx - 1] = 0.0
                sumK = K[:len(extK)] @ extK_mat
                for i, j in swap_pairs:
                    K[i], K[j] = K[j], K[i]
                _K = np.zeros(len_extK)
                _K[idx_inner] = K[idx_inner]
                newK = tuple(sumK + _K)
                updates = {"extK": newK}
                if tau_shift != 0:
                    updates["extT"] = tuple(t + tau_shift for t in prop.extT)
                node.properties = reconstruct(prop, **updates)


def _copy_graph_dag(diags: Sequence[Graph]) -> List[Graph]:
    """Structure-preserving copy of a graph DAG sharing the (immutable)
    property objects — update_extKT_inplace rebuilds the ids it changes, so
    a deepcopy of every DiagPara/tuple inside them is wasted work."""
    memo = {}

    def rec(g: Graph) -> Graph:
        out = memo.get(id(g))
        if out is not None:
            return out
        out = Graph.__new__(Graph)
        out.id = g.id
        out.name = g.name
        out.orders = list(g.orders)
        out.subgraphs = [rec(s) for s in g.subgraphs]
        out.subgraph_factors = list(g.subgraph_factors)
        out.operator = g.operator
        out.weight = g.weight
        out.properties = g.properties
        memo[id(g)] = out
        return out

    return [rec(g) for g in diags]


def update_extKT(diags: Sequence[Graph], para: DiagPara, legK: Sequence[np.ndarray],
                 extra_loop_idx: Optional[int] = None) -> List[Graph]:
    graphs = _copy_graph_dag(diags)
    update_extKT_inplace(graphs, para, legK, extra_loop_idx)
    return graphs
