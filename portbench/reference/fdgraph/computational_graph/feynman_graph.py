"""FeynmanGraph: the Graph IR specialized with QFT metadata.

Carries vertices (OperatorProducts), topology, and external-leg bookkeeping;
``feynman_diagram`` performs the Wick contraction, computing the fermionic
permutation sign.  Reference: FeynmanDiagram.jl/src/computational_graph/
feynmangraph.jl.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from ..quantum_operators import (OperatorProduct, QuantumOperator, correlator_order,
                                 parity)
from .graph import Graph, _approx, uid
from .operators import Op, PROD, SUM, unary_istrivial

# DiagramType tags (feynmangraph.jl:1-8)
class DiagramType:
    INTERACTION = "Interaction"
    EXTERNAL_VERTEX = "ExternalVertex"
    PROPAGATOR = "Propagator"
    SELF_ENERGY = "SelfEnergy"
    VERTEX_DIAG = "VertexDiag"
    GREEN_DIAG = "GreenDiag"
    GENERIC_DIAG = "GenericDiag"


@dataclass
class FeynmanProperties:
    """Diagrammatic metadata for a FeynmanGraph (feynmangraph.jl:23-29)."""
    diagtype: str
    vertices: List[OperatorProduct]
    topology: List[List[int]]
    external_indices: List[int]  # 0-based operator indices
    external_legs: List[bool]

    def __eq__(self, other):
        if not isinstance(other, FeynmanProperties):
            return NotImplemented
        return (self.diagtype == other.diagtype and self.vertices == other.vertices
                and self.topology == other.topology
                and self.external_indices == other.external_indices
                and self.external_legs == other.external_legs)

    def drop_topology(self) -> "FeynmanProperties":
        return FeynmanProperties(self.diagtype, self.vertices, [],
                                 self.external_indices, self.external_legs)


class FeynmanGraph(Graph):
    """Graph node specialized for Feynman diagrams.

    ``properties`` is always a FeynmanProperties.  Graph products of Feynman
    graphs are not defined (feynmangraph.jl:459-461).
    """

    def __init__(self, subgraphs: Sequence["FeynmanGraph"] = (), properties: Optional[FeynmanProperties] = None, *,
                 topology: Optional[List[List[int]]] = None,
                 vertices: Optional[List[OperatorProduct]] = None,
                 external_indices: Optional[List[int]] = None,
                 external_legs: Optional[List[bool]] = None,
                 subgraph_factors: Optional[Sequence[float]] = None,
                 name: str = "", diagtype: str = DiagramType.GENERIC_DIAG,
                 operator: Op = SUM, orders: Optional[Sequence[int]] = None,
                 factor: float = 1.0, weight: float = 0.0):
        if properties is None:
            external_indices = list(external_indices or [])
            external_legs = list(external_legs or [])
            if len(external_indices) != len(external_legs):
                raise ValueError("external_indices and external_legs must have equal length")
            if vertices is None:
                vertices = [external_operators(g) for g in subgraphs
                            if diagram_type(g) != DiagramType.PROPAGATOR]
            properties = FeynmanProperties(diagtype, list(vertices), list(topology or []),
                                           external_indices, external_legs)
        super().__init__(subgraphs, subgraph_factors=subgraph_factors, factor=1.0,
                         name=name, operator=operator, orders=orders, weight=weight,
                         properties=properties)
        if not _approx(factor, 1.0):
            # wrap in a single-child Prod (mirrors Graph's factor handling but
            # keeps the FeynmanGraph type and properties)
            inner = FeynmanGraph.__new__(FeynmanGraph)
            inner.id, inner.name, inner.orders = self.id, self.name, self.orders
            inner.subgraphs, inner.subgraph_factors = self.subgraphs, self.subgraph_factors
            inner.operator, inner.weight, inner.properties = self.operator, self.weight, self.properties
            self.id = uid()
            self.subgraphs = [inner]
            self.subgraph_factors = [factor]
            self.operator = PROD
            self.weight = inner.weight * factor

    # FeynmanGraph arithmetic: only scalar multiple and linear combination
    def __mul__(self, c):
        if isinstance(c, Graph):
            raise TypeError("Multiplication of Feynman graphs is not well defined!")
        return _feynman_scalar_mul(self, c)

    def __rmul__(self, c):
        return _feynman_scalar_mul(self, c)

    def __add__(self, other: "FeynmanGraph") -> "FeynmanGraph":
        return feynman_linear_combination([self, other], [1.0, 1.0])

    def __sub__(self, other: "FeynmanGraph") -> "FeynmanGraph":
        return feynman_linear_combination([self, other], [1.0, -1.0])

    def to_graph(self) -> Graph:
        """Convert to a plain Graph, discarding Feynman properties
        (reference conversions.jl:11-13; shallow on subgraphs)."""
        memo: Dict[int, Graph] = {}

        def rec(g: "FeynmanGraph") -> Graph:
            if g.id in memo:
                return memo[g.id]
            out = Graph([rec(s) for s in g.subgraphs],
                        subgraph_factors=list(g.subgraph_factors), name=g.name,
                        operator=g.operator, orders=list(g.orders), weight=g.weight)
            memo[g.id] = out
            return out

        return rec(self)


# ---------------------------------------------------------------------------
# accessors (feynmangraph.jl:214-295)
# ---------------------------------------------------------------------------

def diagram_type(g: FeynmanGraph) -> str:
    return g.properties.diagtype


def vertices(g: FeynmanGraph) -> List[OperatorProduct]:
    return g.properties.vertices


def vertex(g: FeynmanGraph, i: int = 0) -> OperatorProduct:
    return g.properties.vertices[i]


def topology(g: FeynmanGraph) -> List[List[int]]:
    return g.properties.topology


def external_legs(g: FeynmanGraph) -> List[bool]:
    return g.properties.external_legs


def external_indices(g: FeynmanGraph) -> List[int]:
    return g.properties.external_indices


def external_operators(g: FeynmanGraph) -> OperatorProduct:
    allops = OperatorProduct(g.properties.vertices)
    return OperatorProduct([allops[i] for i in g.properties.external_indices])


def external_labels(g: FeynmanGraph) -> List[int]:
    return [o.label for o in external_operators(g)]


def is_external(g: FeynmanGraph, i: int) -> bool:
    return i in g.properties.external_indices


def is_internal(g: FeynmanGraph, i: int) -> bool:
    return i not in g.properties.external_indices


# ---------------------------------------------------------------------------
# arithmetic (feynmangraph.jl:306-429)
# ---------------------------------------------------------------------------

def _feynman_scalar_mul(g1: FeynmanGraph, c2) -> FeynmanGraph:
    g = FeynmanGraph([g1], g1.properties, subgraph_factors=[c2], operator=PROD,
                     orders=list(g1.orders))
    if unary_istrivial(g1.operator) and g1.onechild():
        g.subgraph_factors[0] = g.subgraph_factors[0] * g1.subgraph_factors[0]
        g.subgraphs = list(g1.subgraphs)
    return g


def feynman_linear_combination(graphs: Sequence[FeynmanGraph],
                               constants: Optional[Sequence[float]] = None) -> FeynmanGraph:
    """Linear combination of Feynman graphs sharing diagram type, orders, and
    external vertices (feynmangraph.jl:397-429)."""
    graphs = list(graphs)
    if constants is None:
        constants = [1.0] * len(graphs)
    g1 = graphs[0]
    if not all(diagram_type(g) == diagram_type(g1) for g in graphs):
        raise ValueError("Graphs are not all of the same graph type.")
    if not all(g.orders == g1.orders for g in graphs):
        raise ValueError("Graphs do not all have the same order.")
    ext_set = set(external_operators(g1))
    if not all(set(external_operators(g)) == ext_set for g in graphs):
        raise ValueError("Graphs do not share the same set of external vertices.")
    total_vertices: List[OperatorProduct] = []
    for g in graphs:
        for v in vertices(g):
            if v not in total_vertices:
                total_vertices.append(v)
    properties = FeynmanProperties(diagram_type(g1), total_vertices, [],
                                   list(external_indices(g1)), list(external_legs(g1)))
    subgraphs = list(graphs)
    subgraph_factors = list(constants)
    for i, sub_g in enumerate(graphs):
        if unary_istrivial(sub_g.operator) and sub_g.onechild():
            subgraph_factors[i] = subgraph_factors[i] * sub_g.subgraph_factors[0]
            subgraphs[i] = sub_g.subgraphs[0]
    unique_graphs: List[FeynmanGraph] = []
    unique_factors: List[float] = []
    index_of: Dict[int, int] = {}
    for g, f in zip(subgraphs, subgraph_factors):
        if g.id in index_of:
            unique_factors[index_of[g.id]] += f
        else:
            index_of[g.id] = len(unique_graphs)
            unique_graphs.append(g)
            unique_factors.append(f)
    return FeynmanGraph(unique_graphs, properties, subgraph_factors=unique_factors,
                        operator=SUM, orders=list(g1.orders))


# ---------------------------------------------------------------------------
# diagram constructors (feynmangraph.jl:496-626)
# ---------------------------------------------------------------------------

def propagator(ops: Union[OperatorProduct, Sequence[QuantumOperator]], *,
               orders: Optional[List[int]] = None, name: str = "",
               factor: float = 1.0, weight: float = 0.0, operator: Op = SUM) -> FeynmanGraph:
    """Propagator-type leaf; applies the correlator-order sign (jl:581-593)."""
    ops = OperatorProduct(ops)
    if len(ops) != 2:
        raise ValueError("propagator expects exactly 2 operators")
    if ops[0].adjoint().operator != ops[1].operator:
        raise ValueError("propagator operators must be mutually adjoint")
    sign, perm = correlator_order(ops)
    kwargs = dict(topology=[[0, 1]], external_indices=perm, external_legs=[True, True],
                  vertices=[OperatorProduct(o) for o in ops],
                  diagtype=DiagramType.PROPAGATOR, name=name, operator=operator,
                  factor=factor * sign, weight=weight)
    if orders is not None:
        kwargs["orders"] = orders
    return FeynmanGraph([], **kwargs)


def interaction(ops: OperatorProduct, *, name: str = "", reorder=None,
                factor: float = 1.0, weight: float = 0.0, operator: Op = SUM) -> FeynmanGraph:
    """Interaction-type leaf (must be bosonic overall; jl:602-613)."""
    if ops.isfermionic():
        raise ValueError("interaction OperatorProduct must be bosonic.")
    if reorder is not None:
        sign, perm = reorder(ops)
        return FeynmanGraph([], external_indices=perm, external_legs=[False] * len(perm),
                            vertices=[OperatorProduct(ops)], diagtype=DiagramType.INTERACTION,
                            name=name, operator=operator, factor=factor * sign, weight=weight)
    ext = list(range(len(ops)))
    return FeynmanGraph([], external_indices=ext, external_legs=[False] * len(ext),
                        vertices=[ops], diagtype=DiagramType.INTERACTION, name=name,
                        operator=operator, factor=factor, weight=weight)


def external_vertex(ops: OperatorProduct, *, name: str = "", factor: float = 1.0,
                    weight: float = 0.0, operator: Op = SUM) -> FeynmanGraph:
    ext = list(range(len(ops)))
    return FeynmanGraph([], external_indices=ext, external_legs=[False] * len(ext),
                        vertices=[ops], diagtype=DiagramType.EXTERNAL_VERTEX, name=name,
                        operator=operator, factor=factor, weight=weight)


def _sortperm(v):
    return sorted(range(len(v)), key=lambda i: v[i])


def feynman_diagram(subgraphs: Sequence[FeynmanGraph], topology: Sequence[Sequence[int]],
                    perm_noleg: Optional[Sequence[int]] = None, *,
                    contraction_orders: Optional[Sequence[Sequence[int]]] = None,
                    factor: float = 1.0, weight: float = 0.0, name: str = "",
                    diagtype: str = DiagramType.GENERIC_DIAG,
                    is_signed: bool = False) -> FeynmanGraph:
    """Wick-contract ``subgraphs`` along ``topology`` into one diagram.

    ``topology`` lists 0-based operator-index pairs to contract; the fermionic
    permutation parity of the contraction supplies the overall sign unless
    ``is_signed``.  Auto-inserts propagator subgraphs per contraction.
    Reference: feynmangraph.jl:496-568.
    """
    topology = [list(c) for c in topology]
    contraction = [i for conn in topology for i in conn]
    if len(set(contraction)) != len(contraction):
        raise ValueError("repeated operator index in topology")

    verts: List[OperatorProduct] = []
    all_external_legs: List[bool] = []
    external_leg: List[int] = []
    external_noleg: List[int] = []
    ind = 0

    subgraphs = copy.deepcopy(list(subgraphs))
    orders_length = len(subgraphs[0].orders)
    diag_orders = [0] * orders_length
    for g in subgraphs:
        diag_orders = [a + b for a, b in zip(diag_orders, g.orders)]
        if diagram_type(g) == DiagramType.PROPAGATOR:
            continue  # exclude propagators to avoid double counting
        verts.append(external_operators(g))
        all_external_legs.extend(external_legs(g))
        if diagram_type(g) == DiagramType.EXTERNAL_VERTEX:
            external_leg.extend(i + ind for i in external_indices(g))
        else:
            shifted = [i + ind for i in external_indices(g)]
            gext = [i for i in shifted if i not in contraction]
            gext_leg = [external_legs(g)[i - ind] for i in gext]
            external_leg.extend(i for i, leg in zip(gext, gext_leg) if leg)
            external_noleg.extend(i for i, leg in zip(gext, gext_leg) if not leg)
        ind += len(external_indices(g))

    for i, has_leg in enumerate(all_external_legs):
        if has_leg and i not in external_noleg and i not in contraction and i not in external_leg:
            raise ValueError("all contracted operators should have no leg.")
    if not set(external_leg) <= set(contraction):
        raise ValueError("leg external operators must be contracted")
    if set(contraction) & set(external_noleg):
        raise ValueError("all nonleg external operators should not be contracted")
    if perm_noleg is not None:
        if len(set(perm_noleg)) != len(perm_noleg) or len(perm_noleg) != len(external_noleg):
            raise ValueError("invalid perm_noleg")
        external_noleg = [external_noleg[i] for i in perm_noleg]

    operators = OperatorProduct(verts)
    permutation = list(dict.fromkeys(contraction + external_noleg))
    if set(permutation) != set(range(len(operators))):
        raise ValueError("permutation must exhaust all operators")

    if not is_signed:
        fermionic = [op.isfermionic() for op in operators]
        fperm = [p for p in permutation if fermionic[p]]
        sign = 1 if not fperm else parity(_sortperm(fperm))
    else:
        sign = 1

    if contraction_orders is None:
        for connection in topology:
            subgraphs.append(propagator(OperatorProduct([operators[c] for c in connection]),
                                        orders=[0] * orders_length))
    else:
        for connection, corders in zip(topology, contraction_orders):
            propagator_orders = [0] * orders_length
            for k, v in enumerate(corders):
                propagator_orders[k] = v
            subgraphs.append(propagator(OperatorProduct([operators[c] for c in connection]),
                                        orders=propagator_orders))
            diag_orders = [a + b for a, b in zip(diag_orders, propagator_orders)]

    _external_indices = list(dict.fromkeys(external_leg + external_noleg))
    _external_legs = [True] * len(external_leg) + [False] * len(external_noleg)
    return FeynmanGraph(subgraphs, topology=topology, external_indices=_external_indices,
                        external_legs=_external_legs, vertices=verts, orders=diag_orders,
                        name=name, diagtype=diagtype, operator=PROD,
                        factor=factor * sign, weight=weight)


# ---------------------------------------------------------------------------
# label transforms (transform.jl:13-96)
# ---------------------------------------------------------------------------

def relabel_inplace(g: FeynmanGraph, label_map: Dict[int, int],
                    _seen: Optional[set] = None) -> FeynmanGraph:
    """Relabel the quantum operators in ``g`` and its subgraphs per ``label_map``
    (e.g. ``{1: 2, 3: 2}`` maps labels 1 and 3 to 2); reference transform.jl:13-27.

    Unlike the reference (which deep-copies subgraphs in ``feynman_diagram``),
    our constructor shares OperatorProduct objects between a graph and its
    subgraphs, so the map is applied once per unique product object.
    """
    if _seen is None:
        _seen = set()
    for op in vertices(g):
        if id(op) in _seen:
            continue
        _seen.add(id(op))
        for j, qo in enumerate(op.operators):
            if qo.label in label_map:
                op.operators[j] = QuantumOperator(qo.operator, label_map[qo.label])
    for sub in g.subgraphs:
        relabel_inplace(sub, label_map, _seen)
    return g


def relabel(g: FeynmanGraph, label_map: Dict[int, int]) -> FeynmanGraph:
    """Copying variant of :func:`relabel_inplace` (transform.jl:39)."""
    return relabel_inplace(copy.deepcopy(g), label_map)


def collect_labels(g: FeynmanGraph) -> List[int]:
    """Sorted unique operator labels in ``g``'s own vertices (transform.jl:49-63)."""
    return sorted({qo.label for op in vertices(g) for qo in op.operators})


def standardize_labels_inplace(g: FeynmanGraph) -> FeynmanGraph:
    """Relabel so labels become (1, 2, 3, ...) in sorted order (transform.jl:76-85)."""
    label_map = {lab: i + 1 for i, lab in enumerate(collect_labels(g))}
    return relabel_inplace(g, label_map)


def standardize_labels(g: FeynmanGraph) -> FeynmanGraph:
    """Copying variant of :func:`standardize_labels_inplace` (transform.jl:96)."""
    return standardize_labels_inplace(copy.deepcopy(g))


def group_by_external(gv: Sequence[FeynmanGraph], indices: Sequence[int]
                      ) -> Dict[tuple, List[FeynmanGraph]]:
    """Group graphs by their external operators at ``indices`` (jl:661-675)."""
    l = len(external_indices(gv[0]))
    if not all(len(external_indices(x)) == l for x in gv):
        raise ValueError("all graphs must have the same number of external indices")
    groups: Dict[tuple, List[FeynmanGraph]] = {}
    for t in gv:
        ext = external_operators(t)
        key = tuple(ext[i] for i in indices)
        groups.setdefault(key, []).append(t)
    return groups
