"""Production Taylor-mode AD: graph -> dict of counterterm graphs.

A copy of ``feynmandiagram_tpu/utility`` with unchanged behaviour, on the
port's own ``computational_graph`` and ``taylor``.  Reference:
FeynmanDiagram.jl/src/utility.jl.  ``taylorAD`` expands every graph in
truncated Taylor series whose coefficients are fresh Graph leaves (for leaf
nodes) or operator applications of child series (for internal nodes); the
resulting coefficient graphs share subgraphs across orders, and all orders
lower into ONE flat IR so that sharing survives on the device.
"""
from __future__ import annotations

import string
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..computational_graph import Graph, SUM
from ..utils.profiling import phased
from ..computational_graph.graph import linear_combination, multi_product
from ..taylor import (TaylorSeries, get_numvars, get_orders, set_variables,
                      taylor_factorial)


def _apply_series(op, series_list: List[TaylorSeries], factors) -> TaylorSeries:
    """Lift a graph operator to Taylor-series algebra (utility.jl:11-13)."""
    if op.kind == "sum":
        result = None
        for s, f in zip(series_list, factors):
            term = s * f
            result = term if result is None else result + term
        return result
    if op.kind == "prod":
        result = None
        for s, f in zip(series_list, factors):
            term = s * f
            result = term if result is None else result * term
        return result
    if op.kind == "power":
        return (series_list[0] ** op.n) * factors[0]
    raise ValueError(f"cannot Taylor-expand operator {op}")


def taylorexpansion(graph: Graph,
                    var_dependence: Optional[Dict[int, List[bool]]] = None, *,
                    to_coeff_map: Optional[Dict[int, TaylorSeries]] = None
                    ) -> Tuple[TaylorSeries, Dict[int, TaylorSeries]]:
    """Taylor series of ``graph`` + a map node-id -> series (utility.jl:105-135).

    ``var_dependence[leaf_id]`` is a bool vector over the registered
    variables; leaves without an entry depend on nothing.  Leaf coefficient
    graphs carry ``orders=o`` and the same ``properties`` as the leaf, so
    downstream leafstates can evaluate them (G/V derivative towers).
    """
    if var_dependence is None:
        var_dependence = {}
    if to_coeff_map is None:
        to_coeff_map = {}
    return _expand(graph, var_dependence, to_coeff_map), to_coeff_map


def _expand(graph: Graph, var_dependence, to_coeff_map) -> TaylorSeries:
    from ..computational_graph.feynman_graph import FeynmanGraph

    if graph.id in to_coeff_map:
        return to_coeff_map[graph.id]
    if graph.isleaf():
        var = var_dependence.get(graph.id, [False] * get_numvars())
        ranges = [range(0, get_orders(idx) + 1) if var[idx] else range(0, 1)
                  for idx in range(get_numvars())]
        import itertools
        result = TaylorSeries()
        is_feynman = isinstance(graph, FeynmanGraph)
        for order in itertools.product(*ranges):
            o = tuple(order)
            if sum(o) == 0 and not is_feynman:
                result.coeffs[o] = graph  # zeroth coefficient is the leaf itself
            else:
                # FeynmanGraph leaves always get fresh Graph coefficients
                # (utility.jl:147-165); Graph leaves only for nonzero orders
                coeff = Graph([], operator=SUM, properties=graph.properties,
                              orders=list(o))
                result.coeffs[o] = coeff
        to_coeff_map[graph.id] = result
        return result
    child_series = [_expand(sub, var_dependence, to_coeff_map) for sub in graph.subgraphs]
    series = _apply_series(graph.operator, child_series, graph.subgraph_factors)
    for g in series.coeffs.values():
        g.properties = graph.properties
    to_coeff_map[graph.id] = series
    return series


def taylorexpansion_graphs(graphs: Sequence[Graph], var_dependence=None, *,
                           to_coeff_map=None):
    if to_coeff_map is None:
        to_coeff_map = {}
    result = []
    for g in graphs:
        series, _ = taylorexpansion(g, var_dependence, to_coeff_map=to_coeff_map)
        result.append(series)
    return result, to_coeff_map


def taylorexpansion_feynman(graphs: Sequence["Graph"],
                            propagator_var: Tuple[List[bool], List[bool]], *,
                            to_coeff_map=None):
    """Variable dependence by propagator statistics for FeynmanGraphs:
    fermionic propagators follow propagator_var[0], bosonic propagator_var[1]
    (utility.jl:187-203)."""
    from ..computational_graph.feynman_graph import DiagramType, diagram_type

    var_dependence: Dict[int, List[bool]] = {}
    for graph in graphs:
        for leaf in graph.leaves():
            if diagram_type(leaf) == DiagramType.PROPAGATOR:
                fermionic = leaf.properties.vertices[0].isfermionic()
                which = 0 if fermionic else 1
                var_dependence[leaf.id] = [bool(propagator_var[which][i])
                                           for i in range(get_numvars())]
    return taylorexpansion_graphs(graphs, var_dependence, to_coeff_map=to_coeff_map)


def taylorexpansion_by_leaftype(graphs: Sequence[Graph],
                                propagator_var: Dict[type, List[bool]], *,
                                to_coeff_map=None):
    """Variable dependence by leaf DiagramId type (utility.jl:217-226)."""
    var_dependence: Dict[int, List[bool]] = {}
    for graph in graphs:
        for leaf in graph.leaves():
            t = type(leaf.properties)
            if t in propagator_var:
                var_dependence[leaf.id] = [bool(x) for x in propagator_var[t]]
    return taylorexpansion_graphs(graphs, var_dependence, to_coeff_map=to_coeff_map)


def _variable_names(n: int) -> str:
    charset = string.ascii_lowercase
    names = []
    for i in range(n):
        if i < 26:
            names.append(charset[i])
        else:
            names.append(names[i - 26] + charset[i % 26])
    return " ".join(names)


@phased("taylorAD")
def taylorAD(graphs: Sequence[Graph], deriv_orders: Sequence[int],
             leaf_dep_funcs: Sequence[Callable], *,
             dict_graphs: Optional[Dict[Tuple[int, ...], List[Graph]]] = None
             ) -> Dict[Tuple[int, ...], List[Graph]]:
    """Taylor-mode AD of ``graphs`` keyed by derivative order (utility.jl:48-93).

    - ``deriv_orders[i]``: max derivative order of variable i
    - ``leaf_dep_funcs[i]``: predicate on leaf ``properties`` deciding whether
      a leaf depends on variable i

    Returns {order-tuple: [coefficient graphs, one per input graph]}.
    """
    if len(deriv_orders) != len(leaf_dep_funcs):
        raise ValueError("deriv_orders and leaf_dep_funcs must have equal length")
    if dict_graphs is None:
        dict_graphs = {}

    from ..taylor import taylor_context

    # scoped registry: the caller's set_variables state is restored on exit
    with taylor_context(_variable_names(len(deriv_orders)),
                        orders=list(deriv_orders)):
        var_dependence: Dict[int, List[bool]] = {}
        visited = set()
        for diag in graphs:
            for leaf in diag.leaves():
                if leaf.id in visited:
                    continue
                visited.add(leaf.id)
                var_dependence[leaf.id] = [bool(f(leaf.properties))
                                           for f in leaf_dep_funcs]

        series_vec, _ = taylorexpansion_graphs(graphs, var_dependence)
        for series in series_vec:
            for orders, graph in series.coeffs.items():
                dict_graphs.setdefault(tuple(orders), []).append(graph)
        return dict_graphs


# ---------------------------------------------------------------------------
# benchmark-only nested-forward AD (utility.jl:314-403): builds high-order
# DERIVATIVES (not Taylor coefficients) by repeated single-variable forward
# AD, used to cross-check the Taylor-series construction above.
# ---------------------------------------------------------------------------

def taylorexpansion_withmap(g: Graph, *, coeffmode: bool = True,
                            var: Optional[List[bool]] = None):
    """Taylor series of a LEAF graph plus a chain-rule map
    {derivative-graph id -> {var idx -> next derivative graph}}
    (utility.jl:268-306).

    With ``coeffmode=False`` the series stores derivatives: each entry is a
    fresh leaf (same ``properties``) that REPRESENTS the o-th derivative
    D_o = o! * c_o of the underlying function, so the chain rule is a pure
    leaf -> leaf map.  (The reference wraps a coefficient leaf with a
    factorial factor instead, utility.jl:288-291; that wrapper does not
    survive trivial-unary inlining here, so the derivative-valued leaf
    convention is used — evaluators must assign such leaves the derivative
    value, not the coefficient.)  Leaf orders stay at zero because
    linear_combination requires uniform orders across mixed children; which
    order a leaf represents is recovered from the returned series
    (``series.coeffs[o].id``).
    """
    if not g.isleaf():
        raise ValueError("taylorexpansion_withmap expects a leaf graph")
    if var is None:
        var = [True] * get_numvars()
    chainrule_map_leaf: Dict[int, Dict[int, Graph]] = {}
    zero = tuple([0] * get_numvars())
    result = TaylorSeries()
    result.coeffs[zero] = g
    current: Dict[Tuple[int, ...], Graph] = {zero: g}
    for _ in range(sum(get_orders())):
        new_func: Dict[Tuple[int, ...], Graph] = {}
        for order, func in current.items():
            cmap = chainrule_map_leaf.setdefault(func.id, {})
            for idx in range(get_numvars()):
                if not var[idx]:
                    continue
                ordernew = list(order)
                ordernew[idx] += 1
                if ordernew[idx] > get_orders(idx):
                    continue
                o = tuple(ordernew)
                if o not in result.coeffs:
                    func_ad = Graph([], operator=SUM, properties=g.properties)
                    new_func[o] = func_ad
                    result.coeffs[o] = func_ad
                    cmap[idx] = func_ad
                else:
                    cmap[idx] = result.coeffs[o]
        current = new_func
    return result, chainrule_map_leaf


def forwardAD_taylor(g: Graph, varidx: int,
                     chainrule_map_leaf: Dict[int, Dict[int, Graph]]
                     ) -> Optional[Graph]:
    """d(g)/d(var varidx) with leaf derivatives taken from the chain-rule map
    (utility.jl:350-403); returns None when g does not depend on the variable.

    Unlike the reference we keep sum factors aligned when some children drop
    out, and preserve the subgraph factor in the Power(1) short-circuit
    (latent misalignments at utility.jl:364-374, 389-396).
    """
    if g.id in chainrule_map_leaf:
        return chainrule_map_leaf[g.id].get(varidx)
    op = g.operator
    if op.kind == "sum":
        children, factors = [], []
        for sub, f in zip(g.subgraphs, g.subgraph_factors):
            d = forwardAD_taylor(sub, varidx, chainrule_map_leaf)
            if d is not None:
                children.append(d)
                factors.append(f)
        return linear_combination(children, factors) if children else None
    if op.kind == "prod":
        terms = []
        for i, sub in enumerate(g.subgraphs):
            d = forwardAD_taylor(sub, varidx, chainrule_map_leaf)
            if d is not None:
                subs = [d if j == i else s for j, s in enumerate(g.subgraphs)]
                terms.append(Graph(subs, operator=g.operator,
                                   subgraph_factors=list(g.subgraph_factors)))
        return linear_combination(terms, [1] * len(terms)) if terms else None
    if op.kind == "power":
        from ..computational_graph.operators import decrement_power
        d = forwardAD_taylor(g.subgraphs[0], varidx, chainrule_map_leaf)
        if d is None:
            return None
        if op.n == 1:
            return Graph([d], operator=SUM,
                         subgraph_factors=[g.subgraph_factors[0]])
        inner = Graph(list(g.subgraphs), operator=decrement_power(op),
                      subgraph_factors=[op.n * g.subgraph_factors[0]])
        return d * inner
    raise ValueError(f"cannot differentiate operator {op}")


def build_derivative_backAD(g: Graph,
                            leaftaylor: Optional[Dict[int, TaylorSeries]] = None):
    """High-order derivative tower of ``g`` by naive nested forward AD
    (utility.jl:314-347).  Returns (TaylorSeries of DERIVATIVES, leaftaylor).

    With derivative leaves (orders=o) assigned the o-th derivative of the
    underlying leaf function, result.coeffs[o] evaluates to the o-th
    derivative of g — i.e. taylor_factorial(o) times what the matching
    ``taylorexpansion`` coefficient gives under coefficient-valued leaves;
    the test suite cross-checks exactly that identity.
    """
    if leaftaylor is None:
        leaftaylor = {}
    chainrule_map_leaf: Dict[int, Dict[int, Graph]] = {}
    for leaf in g.leaves():
        if leaf.id not in leaftaylor:
            leaftaylor[leaf.id], cmap = taylorexpansion_withmap(
                leaf, coeffmode=False)
            chainrule_map_leaf.update(cmap)

    zero = tuple([0] * get_numvars())
    result = TaylorSeries()
    result.coeffs[zero] = g
    current: Dict[Tuple[int, ...], Graph] = {zero: g}
    for _ in range(sum(get_orders())):
        new_func: Dict[Tuple[int, ...], Graph] = {}
        for order, func in current.items():
            for idx in range(get_numvars()):
                ordernew = list(order)
                ordernew[idx] += 1
                if ordernew[idx] > get_orders(idx):
                    continue
                o = tuple(ordernew)
                if o in result.coeffs:
                    continue
                func_ad = forwardAD_taylor(func, idx, chainrule_map_leaf)
                if func_ad is not None:
                    new_func[o] = func_ad
                    result.coeffs[o] = func_ad
        current = new_func
    return result, leaftaylor
