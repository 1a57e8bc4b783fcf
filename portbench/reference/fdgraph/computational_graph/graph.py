"""Core computational-graph IR: a typed mutable DAG node.

This is the host-side symbolic IR of the framework: front ends (Parquet / GV)
emit these graphs, the optimizer and Taylor-mode AD transform them, and the
TPU backend lowers them to flat, level-scheduled edge lists evaluated as
batched segment reductions under ``jax.jit`` (see ``feynmandiagram_tpu_torch.ops``).

Semantics mirror the reference ``Graph{F,W}``
(FeynmanDiagram.jl/src/computational_graph/graph.jl:28-418):

- node value of a Sum node:    sum_i  factor_i * child_i
- node value of a Prod node:   prod_i (factor_i * child_i)
- node value of a Power{N}:    factor_1 * child_1 ** N
- a Unitary node is a constant leaf with a fixed weight

Graph identity is maintained by a per-process uid counter (the generation
phase is inherently sequential and symbolic; the functional/array-form IR
only appears after lowering).  ``uid_reset()`` restarts the counter.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

from .operators import Op, PROD, Power, SUM, UNITARY, unary_istrivial

# ---------------------------------------------------------------------------
# uid counter (reference: common.jl:1-22)
# ---------------------------------------------------------------------------

_uid_counter = itertools.count(1)


def uid() -> int:
    return next(_uid_counter)


def uid_reset() -> None:
    global _uid_counter
    _uid_counter = itertools.count(1)


def _approx(a, b, rtol: float = 1.4901161193847656e-08, atol: float = 0.0) -> bool:
    """Julia-style isapprox for scalars (default rtol = sqrt(eps))."""
    if a == b:
        return True
    try:
        return abs(a - b) <= max(atol, rtol * max(abs(a), abs(b)))
    except TypeError:
        return False


DEFAULT_ORDERS_LEN = 16


class Graph:
    """A computational-graph node.

    Members (reference graph.jl:28-75):
    - ``id``: unique per-process integer id
    - ``name``: optional string name
    - ``orders``: derivative orders associated with the graph
    - ``subgraphs`` / ``subgraph_factors``: children and their scalar factors
    - ``operator``: Op (SUM / PROD / Power(n) / UNITARY)
    - ``weight``: cached scalar weight (filled by ``eval``)
    - ``properties``: opaque metadata (e.g. a DiagramId)
    """

    __slots__ = ("id", "name", "orders", "subgraphs", "subgraph_factors",
                 "operator", "weight", "properties")

    def __init__(self, subgraphs: Sequence["Graph"] = (), *,
                 subgraph_factors: Optional[Sequence[float]] = None,
                 factor: float = 1.0,
                 name: str = "",
                 operator: Op = SUM,
                 orders: Optional[Sequence[int]] = None,
                 weight: float = 0.0,
                 properties: Any = None):
        if operator.kind == "power" and len(subgraphs) != 1:
            raise ValueError("Graph with Power operator must have exactly one subgraph.")
        if operator.kind == "unitary" and len(subgraphs) != 0:
            raise ValueError("Graph with Unitary operator must have no subgraphs.")
        if subgraph_factors is None:
            subgraph_factors = [1.0] * len(subgraphs)
        if len(subgraph_factors) != len(subgraphs):
            raise ValueError("subgraphs and subgraph_factors must have equal length")
        self.id = uid()
        self.name = name
        self.orders = list(orders) if orders is not None else [0] * DEFAULT_ORDERS_LEN
        self.subgraphs: List[Graph] = list(subgraphs)
        self.subgraph_factors: List[float] = list(subgraph_factors)
        self.operator = operator
        self.weight = weight
        self.properties = properties
        # A non-unit `factor` wraps the node in a single-child Prod so the
        # semantic factor survives algebraic manipulation (graph.jl:69-73).
        if not _approx(factor, 1.0):
            inner = Graph.__new__(Graph)
            inner.id, inner.name, inner.orders = self.id, self.name, self.orders
            inner.subgraphs, inner.subgraph_factors = self.subgraphs, self.subgraph_factors
            inner.operator, inner.weight, inner.properties = self.operator, self.weight, self.properties
            self.id = uid()
            self.subgraphs = [inner]
            self.subgraph_factors = [factor]
            self.operator = PROD
            self.weight = inner.weight * factor

    # ------------------------------------------------------------------
    # basic structure queries (reference tree_properties.jl)
    # ------------------------------------------------------------------
    def isleaf(self) -> bool:
        return not self.subgraphs

    def haschildren(self) -> bool:
        return bool(self.subgraphs)

    def onechild(self) -> bool:
        return len(self.subgraphs) == 1

    def eldest(self) -> "Graph":
        if not self.subgraphs:
            raise ValueError("Graph has no children!")
        return self.subgraphs[0]

    def isbranch(self) -> bool:
        return self.onechild() and self.eldest().isleaf()

    def ischain(self) -> bool:
        g = self
        while True:
            if g.isleaf():
                return True
            if not g.onechild():
                return False
            g = g.eldest()

    # ------------------------------------------------------------------
    # traversal (DAG-aware: each unique node id visited once)
    # ------------------------------------------------------------------
    def post_order(self) -> Iterator["Graph"]:
        """Iterative post-order DFS over unique node *objects* (children first).

        Keyed on object identity, not uid: ``deepcopy`` preserves uids, so
        distinct objects may share a uid and must each be visited.
        """
        visited = set()
        stack: List[Tuple[Graph, bool]] = [(self, False)]
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

    def pre_order(self) -> Iterator["Graph"]:
        """Iterative pre-order DFS over unique node objects (parent first)."""
        visited = set()
        stack = [self]
        while stack:
            node = stack.pop()
            if id(node) in visited:
                continue
            visited.add(id(node))
            yield node
            for sub in reversed(node.subgraphs):
                stack.append(sub)

    def leaves(self) -> Iterator["Graph"]:
        for node in self.post_order():
            if node.isleaf():
                yield node

    # ------------------------------------------------------------------
    # equality
    # ------------------------------------------------------------------
    def __eq__(self, other) -> bool:
        """Exact equality (reference abstractgraph.jl:277-300).

        Compares weights approximately, subgraph lists sorted by id, and all
        other fields exactly (including id).
        """
        if not isinstance(other, Graph):
            return NotImplemented
        if type(self) is not type(other):
            return False
        if not _approx(self.weight, other.weight):
            return False
        if len(self.subgraphs) != len(other.subgraphs):
            return False
        pa = sorted(range(len(self.subgraphs)), key=lambda i: self.subgraphs[i].id)
        pb = sorted(range(len(other.subgraphs)), key=lambda i: other.subgraphs[i].id)
        if [self.subgraph_factors[i] for i in pa] != [other.subgraph_factors[i] for i in pb]:
            return False
        for i, j in zip(pa, pb):
            if not (self.subgraphs[i] == other.subgraphs[j]):
                return False
        return (self.id == other.id and self.name == other.name
                and self.orders == other.orders and self.operator == other.operator
                and self.properties == other.properties)

    def __hash__(self) -> int:
        return hash(self.id)

    # ------------------------------------------------------------------
    # arithmetic (reference graph.jl:136-418)
    # ------------------------------------------------------------------
    def __mul__(self, c):
        if isinstance(c, Graph):
            return multi_product(self, c)
        return _scalar_mul(self, c)

    def __rmul__(self, c):
        return _scalar_mul(self, c)

    def __add__(self, other: "Graph") -> "Graph":
        return linear_combination(self, other, 1.0, 1.0)

    def __sub__(self, other: "Graph") -> "Graph":
        return linear_combination(self, other, 1.0, -1.0)

    def __pow__(self, n: int) -> "Graph":
        return Graph([self], operator=Power(n),
                     orders=[o * n for o in self.orders])

    def __repr__(self) -> str:
        from .io import stringrep
        return stringrep(self)


def constant_graph(factor: float = 1.0) -> Graph:
    """A graph representing a constant (reference graph.jl:118-125)."""
    g = Graph([], operator=UNITARY, weight=1.0)
    if _approx(factor, 1.0):
        return g
    return _scalar_mul(g, factor)


def _scalar_mul(g1: Graph, c2) -> Graph:
    g = Graph([g1], subgraph_factors=[c2], operator=PROD, orders=list(g1.orders))
    # inline a trivial unary chain (graph.jl:139-143)
    if unary_istrivial(g1.operator) and g1.onechild():
        g.subgraph_factors[0] = g.subgraph_factors[0] * g1.subgraph_factors[0]
        g.subgraphs = list(g1.subgraphs)
    return g


def _pad_orders(graphs: Sequence[Graph]) -> None:
    maxlen = max(len(g.orders) for g in graphs)
    for g in graphs:
        if len(g.orders) < maxlen:
            g.orders = g.orders + [0] * (maxlen - len(g.orders))


def linear_combination(g1, g2=None, c1=1.0, c2=1.0, *, properties=None):
    """c1*g1 + c2*g2, or a vector linear combination.

    Vector form: ``linear_combination(graphs, constants)``.  Duplicate graphs
    (same id, after trivial-unary inlining) merge by summing their constants.
    Reference: graph.jl:178-262.
    """
    if isinstance(g2, Graph):
        return _linear_combination_pair(g1, g2, c1, c2, properties=properties)
    graphs: List[Graph] = list(g1)
    constants = list(g2) if g2 is not None else [1.0] * len(graphs)
    if not graphs:
        return None
    _pad_orders(graphs)
    ref_orders = graphs[0].orders
    for g in graphs:
        if g.orders != ref_orders:
            raise ValueError("Graphs do not all have the same order.")
    subgraphs = list(graphs)
    subgraph_factors = list(constants)
    for i, sub_g in enumerate(graphs):
        if unary_istrivial(sub_g.operator) and sub_g.onechild():
            subgraph_factors[i] = subgraph_factors[i] * sub_g.subgraph_factors[0]
            subgraphs[i] = sub_g.subgraphs[0]
    unique_graphs: List[Graph] = []
    unique_factors: List[float] = []
    index_of = {}
    for g, f in zip(subgraphs, subgraph_factors):
        if g.id in index_of:
            unique_factors[index_of[g.id]] += f
        else:
            index_of[g.id] = len(unique_graphs)
            unique_graphs.append(g)
            unique_factors.append(f)
    return Graph(unique_graphs, subgraph_factors=unique_factors, operator=SUM,
                 orders=list(ref_orders), properties=properties)


def _linear_combination_pair(g1: Graph, g2: Graph, c1, c2, *, properties=None) -> Graph:
    _pad_orders([g1, g2])
    if g1.orders != g2.orders:
        raise ValueError("g1 and g2 have different orders.")
    subgraphs = [g1, g2]
    subgraph_factors = [c1, c2]
    for i, g in enumerate((g1, g2)):
        if unary_istrivial(g.operator) and g.onechild():
            subgraph_factors[i] = subgraph_factors[i] * g.subgraph_factors[0]
            subgraphs[i] = g.subgraphs[0]
    if subgraphs[0].id == subgraphs[1].id:
        return Graph([subgraphs[0]], subgraph_factors=[subgraph_factors[0] + subgraph_factors[1]],
                     operator=SUM, orders=list(g1.orders), properties=properties)
    return Graph(subgraphs, subgraph_factors=subgraph_factors, operator=SUM,
                 orders=list(g1.orders), properties=properties)


def multi_product(g1, g2=None, c1=1.0, c2=1.0, *, properties=None):
    """c1*g1 * c2*g2, or a vector product.

    Vector form: ``multi_product(graphs, constants)``.  Graphs repeated n>1
    times become a Power(n) subgraph.  Reference: graph.jl:304-401.
    """
    if isinstance(g2, Graph):
        return _multi_product_pair(g1, g2, c1, c2, properties=properties)
    graphs: List[Graph] = list(g1)
    constants = list(g2) if g2 is not None else [1.0] * len(graphs)
    if not graphs:
        return None
    subgraphs = list(graphs)
    subgraph_factors = list(constants)
    _pad_orders(graphs)
    maxlen = len(graphs[0].orders)
    g_orders = [0] * maxlen
    for i, sub_g in enumerate(graphs):
        if unary_istrivial(sub_g.operator) and sub_g.onechild():
            subgraph_factors[i] = subgraph_factors[i] * sub_g.subgraph_factors[0]
            subgraphs[i] = sub_g.subgraphs[0]
        g_orders = [a + b for a, b in zip(g_orders, sub_g.orders)]
    unique_graphs: List[Graph] = []
    unique_factors: List[float] = []
    repeated_counts: List[int] = []
    index_of = {}
    for g, f in zip(subgraphs, subgraph_factors):
        if g.id in index_of:
            loc = index_of[g.id]
            unique_factors[loc] *= f
            repeated_counts[loc] += 1
        else:
            index_of[g.id] = len(unique_graphs)
            unique_graphs.append(g)
            unique_factors.append(f)
            repeated_counts.append(1)
    if len(unique_factors) == 1:
        if repeated_counts[0] == 1:
            return Graph(unique_graphs, subgraph_factors=unique_factors, operator=PROD,
                         orders=g_orders, properties=properties)
        return Graph(unique_graphs, subgraph_factors=unique_factors,
                     operator=Power(repeated_counts[0]), orders=g_orders, properties=properties)
    final_subgraphs: List[Graph] = []
    for idx, g in enumerate(unique_graphs):
        if repeated_counts[idx] == 1:
            final_subgraphs.append(g)
        else:
            final_subgraphs.append(Graph([g], operator=Power(repeated_counts[idx]),
                                         orders=[o * repeated_counts[idx] for o in graphs[0].orders]))
    return Graph(final_subgraphs, subgraph_factors=unique_factors, operator=PROD,
                 orders=g_orders, properties=properties)


def _multi_product_pair(g1: Graph, g2: Graph, c1, c2, *, properties=None) -> Graph:
    subgraphs = [g1, g2]
    subgraph_factors = [c1, c2]
    for i, g in enumerate((g1, g2)):
        if unary_istrivial(g.operator) and g.onechild():
            subgraph_factors[i] = subgraph_factors[i] * g.subgraph_factors[0]
            subgraphs[i] = g.subgraphs[0]
    if subgraphs[0].id == subgraphs[1].id:
        return Graph([subgraphs[0]], subgraph_factors=[subgraph_factors[0] * subgraph_factors[1]],
                     operator=Power(2), orders=[2 * o for o in g1.orders], properties=properties)
    _pad_orders([g1, g2])
    return Graph(subgraphs, subgraph_factors=subgraph_factors, operator=PROD,
                 orders=[a + b for a, b in zip(g1.orders, g2.orders)], properties=properties)


# ---------------------------------------------------------------------------
# structural equivalence (reference abstractgraph.jl:307-350)
# ---------------------------------------------------------------------------

_FIELDS = ("id", "name", "orders", "operator", "properties")


def isequiv(a: Graph, b: Graph, *skip: str) -> bool:
    """Equivalence modulo the fields named in ``skip``.

    Subgraphs are matched as a multiset of (factor, subgraph) pairs with
    recursive isequiv.
    """
    return _isequiv(a, b, frozenset(skip), {})


def _isequiv(a: Graph, b: Graph, skip: frozenset, memo: dict) -> bool:
    if a is b:
        return True
    key = (a.id, b.id)
    if key in memo:
        return memo[key]
    memo[key] = True  # optimistic for cycles (DAGs have none, but shared nodes recur)
    result = _isequiv_impl(a, b, skip, memo)
    memo[key] = result
    return result


def _isequiv_impl(a: Graph, b: Graph, skip: frozenset, memo: dict) -> bool:
    if type(a) is not type(b):
        return False
    if "weight" not in skip and not _approx(a.weight, b.weight):
        return False
    if len(a.subgraphs) != len(b.subgraphs):
        return False
    for field in _FIELDS:
        if field in skip:
            continue
        if getattr(a, field) != getattr(b, field):
            return False
    # extra (subclass) fields
    extra = getattr(type(a), "_EXTRA_EQUIV_FIELDS", ())
    for field in extra:
        if field in skip:
            continue
        if getattr(a, field) != getattr(b, field):
            return False
    b_pairs = list(zip(b.subgraphs, b.subgraph_factors))
    for suba, fa in zip(a.subgraphs, a.subgraph_factors):
        for idx, (subb, fb) in enumerate(b_pairs):
            if fa == fb and _isequiv(suba, subb, skip, memo):
                del b_pairs[idx]
                break
        else:
            return False
    return True
