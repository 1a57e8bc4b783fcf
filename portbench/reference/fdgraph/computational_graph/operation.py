"""First-order forward/backward AD on the graph IR.

These are the AD building blocks; the production renormalization path is
Taylor-mode AD (``utility.taylorAD`` of the JAX package).  Reference:
FeynmanDiagram.jl/src/computational_graph/operation.jl.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .graph import Graph, constant_graph, linear_combination
from .operators import PROD, SUM, decrement_power

Number = (int, float, complex)


def linear_combination_number_with_graph(children: Sequence[Union[float, Graph]],
                                         coeff: Optional[Sequence[float]] = None):
    """Linear combination of mixed numbers and graphs (operation.jl:11-43).

    Returns a Graph if any graph is present (numbers folded into a Unitary
    constant subgraph), a number if all inputs are numbers, or None if empty.
    """
    if coeff is None:
        coeff = [1.0] * len(children)
    subgraphs: List[Graph] = []
    subcoeff: List[float] = []
    subnumber = None
    for child, c in zip(children, coeff):
        if isinstance(child, Number):
            subnumber = child * c if subnumber is None else subnumber + child * c
        elif isinstance(child, Graph):
            subgraphs.append(child)
            subcoeff.append(c)
        else:
            raise TypeError("The type of subgraphs in derivative is incorrect!")
    if subgraphs:
        if subnumber is not None:
            subgraphs.append(constant_graph(subnumber))
            subcoeff.append(1.0)
        return linear_combination(subgraphs, subcoeff)
    return subnumber


def forward_ad(diag: Graph, leaf_id: int):
    """d(diag)/d(leaf with id ``leaf_id``) by forward propagation.

    Reference: operation.jl:53-124.
    """
    dual: Dict[int, Union[float, Graph]] = {}
    for d in diag.post_order():
        if d.id in dual:
            continue
        if d.isleaf():
            if d.id == leaf_id:
                dual[d.id] = 1.0
            continue
        op = d.operator
        if op.kind == "sum":
            children = []
            coeff = []
            for i, sub in enumerate(d.subgraphs):
                if sub.id in dual:
                    children.append(dual[sub.id])
                    coeff.append(d.subgraph_factors[i])
            dum = linear_combination_number_with_graph(children, coeff)
            if dum is not None:
                dual[d.id] = dum
        elif op.kind == "prod":
            # d(Π_i f_i g_i) = (Π_i f_i) Σ_i g_i' Π_{j≠i} g_j
            # (NOTE: the reference operation.jl:82-101 accumulates only the
            # factors of differentiated children — correct only for unit
            # factors; here all factors are included.)
            factor = 1.0
            for f in d.subgraph_factors:
                factor *= f
            children = []
            for si, sub in enumerate(d.subgraphs):
                if sub.id not in dual:
                    continue
                child = dual[sub.id]
                for sj, other in enumerate(d.subgraphs):
                    if si != sj:
                        if isinstance(child, Number):
                            child = other * child
                        else:
                            child = child * other
                children.append(child)
            dum = linear_combination_number_with_graph(children)
            if dum is not None:
                dual[d.id] = factor * dum if isinstance(dum, Number) else dum * factor
        elif op.kind == "power":
            sub = d.subgraphs[0]
            if sub.id not in dual:
                continue
            lowered = Graph(list(d.subgraphs), subgraph_factors=[op.n],
                            operator=decrement_power(op))
            child = dual[sub.id]
            if isinstance(child, Number):
                child_g = constant_graph(child)
            else:
                child_g = child
            dual[d.id] = Graph([lowered, child_g],
                               subgraph_factors=[d.subgraph_factors[0], 1.0], operator=PROD)
    if diag.id not in dual:
        return 0.0
    return dual[diag.id]


def all_parent(diag: Graph) -> Dict[int, List[Graph]]:
    """Map each node id to its list of parent nodes (operation.jl:134-150)."""
    result: Dict[int, List[Graph]] = {}
    for d in diag.post_order():
        result.setdefault(d.id, [])
    for g in diag.post_order():
        for sub in g.subgraphs:
            parents = result[sub.id]
            if all(p.id != g.id for p in parents):
                parents.append(g)
    return result


def node_derivative(g1: Graph, g2: Graph):
    """Local derivative d g1 / d g2 considering only g1's immediate children.

    Reference: operation.jl:161-223.
    """
    if g1.isleaf():
        return None
    op = g1.operator
    if op.kind == "sum":
        sum_factor = 0.0
        exist = False
        for i, sub in enumerate(g1.subgraphs):
            if sub.id == g2.id:
                exist = True
                sum_factor += g1.subgraph_factors[i]
        return sum_factor if exist else None
    if op.kind == "prod":
        count = 0
        subgraphs: List[Graph] = []
        subgraphfactors: List[float] = []
        factor = None
        first_time = True
        for i, sub in enumerate(g1.subgraphs):
            if sub.id == g2.id:
                if first_time:
                    first_time = False
                    factor = g1.subgraph_factors[i]
                    count += 1
                else:
                    count += 1
                    subgraphs.append(sub)
                    subgraphfactors.append(g1.subgraph_factors[i])
            else:
                subgraphs.append(sub)
                subgraphfactors.append(g1.subgraph_factors[i])
        if count == 0:
            return None
        if not subgraphs:
            return factor
        if factor is not None:
            subgraphfactors[0] = subgraphfactors[0] * count * factor
        g = Graph(subgraphs, subgraph_factors=subgraphfactors, operator=PROD,
                  orders=list(g1.orders), name=g1.name, properties=g1.properties)
        return g
    if op.kind == "power":
        if g1.subgraphs[0].id == g2.id:
            return Graph(list(g1.subgraphs),
                         subgraph_factors=[f * op.n for f in g1.subgraph_factors],
                         operator=decrement_power(op))
        return None
    return None


def _recursive_back_ad(diag: Graph, parents, dual, result, root_id: int):
    if diag.id not in dual:
        derivative_list: List[Union[float, Graph]] = []
        if not parents[diag.id]:
            dual[diag.id] = 1.0
        else:
            for parent in parents[diag.id]:
                parent_ad = _recursive_back_ad(parent, parents, dual, result, root_id)
                d_node = node_derivative(parent, diag)
                if d_node is not None and parent_ad is not None:
                    if isinstance(d_node, Number) and isinstance(parent_ad, Number):
                        derivative_list.append(d_node * parent_ad)
                    elif isinstance(d_node, Number):
                        derivative_list.append(parent_ad * d_node)
                    elif isinstance(parent_ad, Number):
                        derivative_list.append(d_node * parent_ad)
                    else:
                        derivative_list.append(d_node * parent_ad)
            dual[diag.id] = linear_combination_number_with_graph(derivative_list)
    if diag.isleaf():
        val = dual[diag.id]
        if isinstance(val, Number):
            result[(root_id, diag.id)] = constant_graph(val)
        elif val is not None:
            result[(root_id, diag.id)] = val
    return dual[diag.id]


def back_ad(diag: Graph) -> Dict[Tuple[int, int], Graph]:
    """Backward AD: d(diag)/d(leaf) for every leaf (operation.jl:252-265)."""
    dual: Dict[int, Union[float, Graph, None]] = {}
    result: Dict[Tuple[int, int], Graph] = {}
    parents = all_parent(diag)
    for d in diag.leaves():
        if d.operator.kind == "unitary" or d.id in dual:
            continue
        _recursive_back_ad(d, parents, dual, result, diag.id)
    return result


def build_all_leaf_derivative(diag: Graph, maxorder: float = float("inf")):
    """All mixed leaf derivatives up to maxorder (operation.jl:283-325)."""
    result: Dict[Tuple[Tuple[int, int], ...], Graph] = {}
    chainrule_map: Dict[int, List[Graph]] = {}
    current_func = {(diag.id, diag.id): diag}
    order_dict: Dict[int, Dict[int, int]] = {}
    order: Dict[int, int] = {}
    leafmap: Dict[int, Graph] = {}
    for leaf in diag.leaves():
        leafmap[leaf.id] = leaf
        order[leaf.id] = 0

    def freeze(o: Dict[int, int]):
        return tuple(sorted(o.items()))

    order_dict[diag.id] = order
    result[freeze(order)] = diag
    i = 1
    while current_func and i <= maxorder:
        new_func = {}
        for (rid, fid), func in current_func.items():
            chainrule_map.setdefault(func.id, [])
            ad = back_ad(func)
            for (ad_root, ad_leaf), func_ad in ad.items():
                chainrule_map[func.id].append(leafmap[ad_leaf])
                o = dict(order_dict[func.id])
                o[ad_leaf] += 1
                if freeze(o) not in result:
                    new_func[(ad_root, ad_leaf)] = func_ad
                    order_dict[func_ad.id] = o
                    result[freeze(o)] = func_ad
                    chainrule_map[func.id].append(func_ad)
                else:
                    chainrule_map[func.id].append(result[freeze(o)])
        current_func = new_func
        i += 1
    return result, chainrule_map


# ---------------------------------------------------------------------------
# root-driven forward AD (operation.jl:354-450) and high-order towers
# ---------------------------------------------------------------------------

def forward_ad_root(graphs, idx: int = 0, dual: Optional[Dict] = None,
                    num_vars: int = 1) -> Dict:
    """Forward AD seeded at the roots, with placeholder "UNDEFINED" leaf duals.

    dual maps (node_id, key2) -> dual graph, where key2 is an N-bool tuple
    with True at the differentiation variable index ``idx`` (0-based).
    """
    if isinstance(graphs, Graph):
        graphs = [graphs]
    if dual is None:
        dual = {}
    key2 = tuple(i == idx for i in range(num_vars))
    for diag in graphs:
        for node in diag.pre_order():
            visited = False
            key_node = (node.id, key2)
            if key_node in dual:
                if dual[key_node].name != "UNDEFINED":
                    continue
                visited = True
            op = node.operator
            if op.kind == "sum":
                nodes_deriv = []
                for sub_node in node.subgraphs:
                    key = (sub_node.id, key2)
                    if key in dual:
                        nodes_deriv.append(dual[key])
                    else:
                        subnode_dual = Graph([], name="UNDEFINED")
                        nodes_deriv.append(subnode_dual)
                        dual[key] = subnode_dual
                if visited:
                    dual[key_node].subgraphs = nodes_deriv
                    dual[key_node].subgraph_factors = list(node.subgraph_factors)
                    dual[key_node].name = node.name
                else:
                    dual[key_node] = Graph(nodes_deriv, subgraph_factors=list(node.subgraph_factors))
            elif op.kind == "prod":
                nodes_deriv = []
                for i, sub_node in enumerate(node.subgraphs):
                    key = (sub_node.id, key2)
                    if key not in dual:
                        dual[key] = Graph([], name="UNDEFINED")
                    subs = [dual[key] if j == i else subg for j, subg in enumerate(node.subgraphs)]
                    nodes_deriv.append(Graph(subs, operator=PROD,
                                             subgraph_factors=list(node.subgraph_factors)))
                if visited:
                    dual[key_node].subgraphs = nodes_deriv
                    dual[key_node].subgraph_factors = [1.0] * len(nodes_deriv)
                    dual[key_node].name = node.name
                else:
                    dual[key_node] = Graph(nodes_deriv)
            elif op.kind == "power":
                nodes_deriv = []
                key = (node.subgraphs[0].id, key2)
                if key in dual:
                    nodes_deriv.append(dual[key])
                else:
                    subnode_dual = Graph([], name="UNDEFINED")
                    nodes_deriv.append(subnode_dual)
                    dual[key] = subnode_dual
                nodes_deriv.append(Graph(list(node.subgraphs), subgraph_factors=[op.n],
                                         operator=decrement_power(op)))
                if visited:
                    dual[key_node].subgraphs = nodes_deriv
                    dual[key_node].subgraph_factors = [1.0, node.subgraph_factors[0]]
                    dual[key_node].name = node.name
                    dual[key_node].operator = PROD
                else:
                    dual[key_node] = Graph(nodes_deriv,
                                           subgraph_factors=[1.0, node.subgraph_factors[0]],
                                           operator=PROD)
    return dual


def _find_last_neighbor(item: Tuple[int, ...]):
    loc = None
    for j in range(len(item) - 1, -1, -1):
        if item[j] > 0:
            loc = j
            break
    if loc is None:
        return None
    return tuple(v - 1 if j == loc else v for j, v in enumerate(item))


def build_derivative_graph(graphs, orders: Tuple[int, ...], nodes_id=None) -> Dict:
    """Mixed high-order derivative graphs via iterated forward_ad_root.

    Returns dual[(node_id, order_tuple)] -> derivative graph.
    Reference: operation.jl:478-537.
    """
    if isinstance(graphs, Graph):
        graphs = [graphs]
    N = len(orders)
    roots_id = {g.id for g in graphs}
    if nodes_id is None:
        nodes_id = set()
        for g in graphs:
            for leaf in g.leaves():
                nodes_id.add(leaf.id)

    dual_oneorder: Dict = {}
    cumsum_orders = list(itertools.accumulate(orders))
    idx0 = next(i for i, val in enumerate(cumsum_orders) if val >= 1)
    first_order = tuple(1 if j == idx0 else 0 for j in range(N))

    dual_oneorder = forward_ad_root(graphs, idx0, dual_oneorder, num_vars=N)
    dual_graphs = [dual_oneorder[(g.id, first_order)] for g in graphs]
    for x in range(2, sum(orders) + 1):
        idx = next(i for i, val in enumerate(cumsum_orders) if val >= x)
        dual_oneorder = forward_ad_root(dual_graphs, idx, dual_oneorder, num_vars=N)
        key2 = tuple(j == idx for j in range(N))
        dual_graphs = [dual_oneorder[(g.id, key2)] for g in dual_graphs]

    dual: Dict = {}
    iter_orders = [range(0, x + 1) for x in orders]
    for node_id in nodes_id:
        for order in itertools.product(*iter_orders):
            if order == tuple([0] * N):
                continue
            prev_order = _find_last_neighbor(order)
            diff = tuple(p != o for p, o in zip(prev_order, order))
            if prev_order == tuple([0] * N):
                dual[(node_id, order)] = dual_oneorder[(node_id, diff)]
            else:
                dual[(node_id, order)] = dual_oneorder[(dual[(node_id, prev_order)].id, diff)]

    _cum = [0] + cumsum_orders
    for root_id in roots_id:
        dual[(root_id, first_order)] = dual_oneorder[(root_id, first_order)]
        prev_order = first_order
        for x in range(2, sum(orders) + 1):
            idx = next(i for i, val in enumerate(cumsum_orders) if val >= x)
            order = tuple(x - _cum[idx] if j == idx else (orders[j] if j < idx else 0)
                          for j in range(N))
            diff = tuple(p != o for p, o in zip(prev_order, order))
            dual[(root_id, order)] = dual_oneorder[(dual[(root_id, prev_order)].id, diff)]
            prev_order = order
    return dual
