"""The port's Taylor-mode AD (``taylor`` and ``utility``) against the JAX
package's, case by case as ``tests/test_taylor.py`` checks the reference.

Each case runs in both packages (``pkg``), each with its own graph classes,
its own variable registry and its own ``taylorAD``; where a case yields
numbers, strings or counts, the port's must equal the reference's exactly
(both are the same host arithmetic on the same graphs).  The registry cases
also interleave the two packages in one process: neither may see or clobber
the other's variables.
"""
import importlib
import math

import pytest

from test_torch_host import PORT, REF

PKGS = [REF, PORT]


def mods(pkg):
    """The modules of ``pkg`` a case needs, by short name."""
    names = ("taylor", "utility", "computational_graph", "frontends",
             "frontends.parquet")
    return [importlib.import_module(f"{pkg}.{n}") for n in names]


@pytest.fixture(autouse=True)
def _fresh_registries_and_uids():
    """Both packages start a case from a fresh uid counter and the default
    registry, so graph ids and printed names agree between them."""
    for pkg in PKGS:
        taylor, _, cg, _, _ = mods(pkg)
        cg.uid_reset()
        taylor.set_variables("x1 x2", orders=[2, 2])
    yield


def polynomial_coeffs(pkg):
    taylor = mods(pkg)[0]
    a, b, c, d, e = taylor.set_variables("a b c d e", orders=[3, 3, 3, 3, 3])
    F1 = (a + b) * (a + b) * (a + b)
    F2 = (1 + a) * (3 + 2 * c)
    F3 = (a + b) ** 3
    return [dict(sorted(F.coeffs.items())) for F in (F1, F2, F3)]


@pytest.mark.parametrize("pkg", PKGS)
def test_polynomial_algebra(pkg):
    F1, F2, F3 = polynomial_coeffs(pkg)
    assert F1[(2, 1, 0, 0, 0)] == F1[(1, 2, 0, 0, 0)] == 3.0
    assert F1[(3, 0, 0, 0, 0)] == F1[(0, 3, 0, 0, 0)] == 1.0
    assert F2[(0, 0, 0, 0, 0)] == F2[(1, 0, 0, 0, 0)] == 3.0
    assert F2[(0, 0, 1, 0, 0)] == F2[(1, 0, 1, 0, 0)] == 2.0
    assert F3[(2, 1, 0, 0, 0)] == F3[(1, 2, 0, 0, 0)] == 3.0
    assert F3[(3, 0, 0, 0, 0)] == 1.0
    assert polynomial_coeffs(PORT) == polynomial_coeffs(REF)


@pytest.mark.parametrize("pkg", PKGS)
def test_truncation(pkg):
    taylor = mods(pkg)[0]
    a, = taylor.set_variables("a", orders=[2])
    F = (a + 1) ** 4
    assert [F.get_coeff([o]) for o in (0, 1, 2)] == [1.0, 4.0, 6.0]
    assert len(F.coeffs) == 3
    assert F.get_derivative([2]) == 12.0 and F.get_coeff([3]) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_factorials_and_binomials(pkg):
    taylor = mods(pkg)[0]
    assert taylor.taylor_factorial([2, 3]) == 12
    assert taylor.taylor_binomial([1, 0], [1, 1]) == 2
    port, ref = mods(PORT)[0], mods(REF)[0]
    for o1, o2 in [([0, 0], [0, 0]), ([2, 1], [1, 3]), ([4], [2]), ([1, 2, 3], [3, 2, 1])]:
        assert port.taylor_binomial(o1, o2) == ref.taylor_binomial(o1, o2)
        assert port.taylor_factorial(o1 + o2) == ref.taylor_factorial(o1 + o2)
    with pytest.raises(ValueError):
        taylor.taylor_binomial([1], [1, 2])


def _getdiagram(pkg, spin=2.0, D=3, Nk=4, Nt=2):
    """The hand-built 2-bubble diagram of taylor.jl:113-161, in ``pkg``."""
    _, _, cg, fe, pq = mods(pkg)
    Graph, PROD, SUM = cg.Graph, cg.PROD, cg.SUM
    paraG = pq.DiagPara(type=pq.GreenDiag, innerLoopNum=0, totalLoopNum=Nk,
                        hasTau=True, totalTauNum=Nt)
    gK = [[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0]]
    gT = [(1, 2), (2, 1)]
    g = [Graph([], properties=fe.BareGreenId(k=gK[i], t=gT[i]), name="G")
         for i in range(2)]
    vdK = [[0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 1.0, 0.0]]
    vd = [Graph([], properties=fe.BareInteractionId(fe.ChargeCharge, k=vdK[i], t=(0, 0)),
                name="Vd") for i in range(2)]
    veK = [[1, 0, -1, -1], [0, 1, 0, -1]]
    ve = [Graph([], properties=fe.BareInteractionId(fe.ChargeCharge, k=veK[i], t=(0, 0)),
                name="Ve") for i in range(2)]
    Id = fe.GenericId(paraG)
    ggn = Graph([g[0], g[1]], properties=Id, operator=PROD)
    vdd = Graph([vd[0], vd[1]], properties=Id, operator=PROD, factor=spin)
    vde = Graph([vd[0], ve[1]], properties=Id, operator=PROD, factor=-1.0)
    ved = Graph([ve[0], vd[1]], properties=Id, operator=PROD, factor=-1.0)
    vsum = Graph([vdd, vde, ved], properties=Id, operator=SUM)
    return Graph([vsum, ggn], properties=Id, operator=PROD,
                 factor=1 / (2 * math.pi) ** D, name="root")


def analytic_coefficients(pkg, spin=0.5, D=3):
    """taylor.jl:181-208: each coefficient of the 2-bubble diagram with every
    leaf derivative 1 (coefficient 1/o!)."""
    taylor, utility, cg, fe, _ = mods(pkg)
    root = _getdiagram(pkg, spin, D)
    cg.optimize_inplace([root])
    taylor.set_variables("x y", orders=[2, 2])
    propagator_var = {fe.BareGreenId: [True, False], fe.BareInteractionId: [False, True]}
    (t,), taylormap = utility.taylorexpansion_by_leaftype([root], propagator_var)
    leafmap, leafvec = {}, []
    for leaf in root.leaves():
        for order, coeff in taylormap[leaf.id].coeffs.items():
            leafmap[coeff.id] = len(leafvec)
            leafvec.append(1.0 / taylor.taylor_factorial(order))
    return {o: cg.eval_graph(g, leafmap, leafvec) for o, g in sorted(t.coeffs.items())}


@pytest.mark.parametrize("pkg", PKGS)
def test_analytic_coefficients(pkg):
    spin, D = 0.5, 3
    factor = 1 / (2 * math.pi) ** D
    got = analytic_coefficients(pkg, spin, D)
    assert set(got) == {(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (0, 2), (1, 2), (2, 1),
                        (2, 2)}
    for o, k in [((0, 0), 1), ((0, 1), 2), ((1, 0), 2), ((1, 1), 4), ((2, 0), 4), ((0, 2), 4)]:
        want = (-2 + spin) * k * factor / math.factorial(o[0]) / math.factorial(o[1])
        assert got[o] == pytest.approx(want)
    assert analytic_coefficients(PORT) == analytic_coefficients(REF)


def taylorad_summary(pkg, deriv_orders=(2, 2), deps=None):
    """taylorAD of the 2-bubble diagram: per order tuple, the evaluated
    coefficient graph (leaves valued by their id, for a check that
    distinguishes leaves) and its leaves' orders."""
    _, utility, cg, fe, _ = mods(pkg)
    root = _getdiagram(pkg, 2.0)
    deps = deps or [lambda p: isinstance(p, fe.BareGreenId),
                    lambda p: isinstance(p, fe.BareInteractionId)]
    dict_g = utility.taylorAD([root], list(deriv_orders), deps)
    out = {}
    for o, (g,) in sorted(dict_g.items()):
        leaves = [leaf for leaf in g.leaves() if leaf.operator.kind != "unitary"]
        leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
        vals = [1.0 + 0.1 * i for i in range(len(leaves))]
        out[o] = (cg.eval_graph(g, leafmap, vals),
                  sorted(tuple(leaf.orders) for leaf in leaves))
    return root, dict_g, out


@pytest.mark.parametrize("pkg", PKGS)
def test_taylorAD_api(pkg):
    cg = mods(pkg)[2]
    root, dict_g, _ = taylorad_summary(pkg)
    assert (0, 0) in dict_g and (2, 2) in dict_g and len(dict_g) == 9
    assert cg.eval_graph(dict_g[(0, 0)][0]) == pytest.approx(cg.eval_graph(root))
    assert taylorad_summary(PORT)[2] == taylorad_summary(REF)[2]


@pytest.mark.parametrize("pkg", PKGS)
def test_counterterm_leaf_orders(pkg):
    """Leaf coefficient graphs carry orders=o and the leaf's properties."""
    fe = mods(pkg)[3]
    deps = [lambda p: isinstance(p, fe.BareGreenId), lambda p: False]
    _, dict_g, summary = taylorad_summary(pkg, (1, 0), deps)
    g10 = dict_g[(1, 0)][0]
    leaf_orders = {tuple(leaf.orders) for leaf in g10.leaves()
                   if isinstance(leaf.properties, fe.BareGreenId)}
    assert (1, 0) in leaf_orders
    fe_r = mods(REF)[3]
    deps_r = [lambda p: isinstance(p, fe_r.BareGreenId), lambda p: False]
    assert summary == taylorad_summary(REF, (1, 0), deps_r)[2]


def _eval_ad(pkg, graph, base, mode, leaftaylor=None):
    """Evaluate ``graph`` with leaf i as f_i(x, y) = v_i exp(x + y): every
    derivative is v_i and the order-o coefficient v_i / o!."""
    taylor, _, cg, _, _ = mods(pkg)
    order_of = {}
    if leaftaylor is not None:
        for series in leaftaylor.values():
            for o, coeff in series.coeffs.items():
                order_of[coeff.id] = o
    leafmap, vals = {}, []
    for leaf in graph.leaves():
        if leaf.operator.kind == "unitary" or leaf.id in leafmap:
            continue
        o = order_of.get(leaf.id, tuple(leaf.orders))
        leafmap[leaf.id] = len(vals)
        v = base[leaf.properties]
        vals.append(v if mode == "deriv" else v / taylor.taylor_factorial(o))
    return cg.eval_graph(graph, leafmap, vals)


def nested_forward_ad(pkg):
    """build_derivative_backAD against taylorexpansion: derivative(o) ==
    o! * coefficient(o) (utility.jl:314-403); returns both per order."""
    taylor, utility, cg, _, _ = mods(pkg)
    taylor.set_variables("x y", orders=[2, 2])
    l1, l2, l3 = (cg.Graph([], properties=("leaf", i)) for i in (1, 2, 3))
    g = (l1 + 2.0 * l2) * l3 + l1 * l1 * 0.5
    base = {("leaf", 1): 1.3, ("leaf", 2): 0.7, ("leaf", 3): -0.4}
    series, _ = utility.taylorexpansion(g, {leaf.id: [True, True] for leaf in (l1, l2, l3)})
    deriv, leaftaylor = utility.build_derivative_backAD(g)
    assert set(deriv.coeffs) == set(series.coeffs)
    return {o: (taylor.taylor_factorial(o) * _eval_ad(pkg, series.coeffs[o], base, "coeff"),
                _eval_ad(pkg, dgraph, base, "deriv", leaftaylor))
            for o, dgraph in sorted(deriv.coeffs.items())}


@pytest.mark.parametrize("pkg", PKGS)
def test_nested_forward_ad_matches_taylorexpansion(pkg):
    got = nested_forward_ad(pkg)
    for o, (want, have) in got.items():
        assert have == pytest.approx(want, rel=1e-12), o
    assert nested_forward_ad(PORT) == nested_forward_ad(REF)


def power_operator(pkg):
    taylor, utility, cg, _, _ = mods(pkg)
    taylor.set_variables("x", orders=[3])
    l1 = cg.Graph([], properties=("leaf", 1))
    g = cg.Graph([l1], operator=cg.Power(3), subgraph_factors=[2.0])
    base = {("leaf", 1): 0.9}
    series, _ = utility.taylorexpansion(g, {l1.id: [True]})
    deriv, leaftaylor = utility.build_derivative_backAD(g)
    return {o: (taylor.taylor_factorial(o) * _eval_ad(pkg, series.coeffs[o], base, "coeff"),
                _eval_ad(pkg, dgraph, base, "deriv", leaftaylor))
            for o, dgraph in sorted(deriv.coeffs.items())}


@pytest.mark.parametrize("pkg", PKGS)
def test_power_operator(pkg):
    got = power_operator(pkg)
    assert len(got) == 4
    for o, (want, have) in got.items():
        assert have == pytest.approx(want, rel=1e-12), o
    assert power_operator(PORT) == power_operator(REF)


def printed(pkg):
    taylor, utility, cg, _, _ = mods(pkg)
    x, y = taylor.set_variables("x y", orders=[2, 2])
    F = (1 + x) * (3 + 2 * y)
    numeric = (taylor.pretty_print(F, big_o=False), str(F), str(x - 2.5 * x * y))
    taylor.set_variables("x", orders=[1])
    l1 = cg.Graph([], properties=("leaf", 1))
    series, _ = utility.taylorexpansion(l1, {l1.id: [True]})
    return numeric + (taylor.pretty_print(series, big_o=False), str(series))


@pytest.mark.parametrize("pkg", PKGS)
def test_pretty_print(pkg):
    numeric, big_o, _, graphs, graphs_big_o = printed(pkg)
    assert "x y" in numeric and "3" in numeric and "𝒪" in big_o
    assert "g" in graphs and " x" in graphs and "𝒪(x²)" in graphs_big_o
    mods(REF)[2].uid_reset()
    mods(PORT)[2].uid_reset()
    assert printed(PORT) == printed(REF)


def operation_counts(pkg):
    taylor, utility, cg, _, _ = mods(pkg)
    taylor.set_variables("x", orders=[2])
    l1 = cg.Graph([], properties=("leaf", 1))
    l2 = cg.Graph([], properties=("leaf", 2))
    g = l1 * l2 + l1
    series, _ = utility.taylorexpansion(g, {l1.id: [True], l2.id: [True]})
    return (cg.count_operation(series), cg.count_operation([series]),
            cg.count_operation(series.coeffs))


@pytest.mark.parametrize("pkg", PKGS)
def test_count_operation_series(pkg):
    (adds, muls), listed, by_dict = operation_counts(pkg)
    assert adds > 0 and muls > 0 and listed == by_dict == [adds, muls]
    assert operation_counts(PORT) == operation_counts(REF)


@pytest.mark.parametrize("pkg", PKGS)
def test_taylor_context_restores(pkg):
    taylor = mods(pkg)[0]
    taylor.set_variables("u v w", orders=[1, 2, 3])
    with taylor.taylor_context("x", orders=[5]) as (x,):
        assert taylor.get_numvars() == 1 and taylor.get_orders() == [5]
        assert (x * x).get_coeff([2]) == 1.0
    assert taylor.get_numvars() == 3 and taylor.get_orders() == [1, 2, 3]
    assert taylor.get_variable_names() == ["u", "v", "w"]


@pytest.mark.parametrize("pkg", PKGS)
def test_taylorad_does_not_clobber_registry(pkg):
    taylor, utility, cg, _, _ = mods(pkg)
    taylor.set_variables("a b", orders=[4, 4])
    leaf = cg.Graph([], properties=("g", 1))
    utility.taylorAD([leaf], [2], [lambda p: True])
    assert taylor.get_orders() == [4, 4] and taylor.get_variable_names() == ["a", "b"]


def test_registries_interleaved_in_one_process():
    """Each package keeps its own registry: set_variables, taylor_context
    and taylorAD in one package, interleaved with the other's, never change
    what the other sees, and series built in each truncate at their own
    package's orders."""
    port, ref = mods(PORT)[0], mods(REF)[0]
    assert port is not ref and port.TaylorSeries is not ref.TaylorSeries
    (xp,) = port.set_variables("p", orders=[3])
    xr, yr = ref.set_variables("r s", orders=[1, 2])
    assert port.get_variable_names() == ["p"] and port.get_orders() == [3]
    assert ref.get_variable_names() == ["r", "s"] and ref.get_orders() == [1, 2]
    with port.taylor_context("q", orders=[1]):
        assert ref.get_orders() == [1, 2] and port.get_orders() == [1]
        with ref.taylor_context("t u v", orders=[2, 2, 2]):
            assert port.get_orders() == [1] and ref.get_numvars() == 3
        assert ref.get_orders() == [1, 2]
    assert port.get_orders() == [3]
    # a taylorAD in each package leaves both registries as they were
    for pkg in (PORT, REF):
        cg, utility = mods(pkg)[2], mods(pkg)[1]
        utility.taylorAD([cg.Graph([], properties=("g", 1))], [2, 2, 2],
                         [lambda p: True] * 3)
        assert port.get_orders() == [3] and ref.get_orders() == [1, 2]
    # series truncate at their own package's caps
    assert sorted(((xp + 1) ** 5).coeffs) == [(0,), (1,), (2,), (3,)]
    assert sorted(((xr + yr + 1) ** 4).coeffs) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1),
                                                   (1, 2)]
    assert (xp ** 3).get_coeff([3]) == 1.0 and (xr ** 2).get_coeff([2]) is None


def test_port_taylor_runs_on_the_port_graph_classes():
    """The port's copies are modules of their own, on the port's graph
    classes: a port graph's series coefficient is a port Graph."""
    taylor, utility, cg, _, _ = mods(PORT)
    assert taylor.__name__ == f"{PORT}.taylor" and utility.Graph is cg.Graph
    assert utility.TaylorSeries is taylor.TaylorSeries
    taylor.set_variables("x", orders=[1])
    leaf = cg.Graph([], properties=("leaf", 1))
    series, _ = utility.taylorexpansion(leaf, {leaf.id: [True]})
    assert type(series.coeffs[(1,)]).__module__.startswith(PORT + ".")


def test_taylor_expansion_example_prints_the_reference_table(capsys, monkeypatch):
    """``examples/taylor_expansion.py`` and its port print the same order
    tuples and operation counts, letter for letter."""
    import os
    import runpy
    from feynmandiagram_tpu_torch.examples import taylor_expansion

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr("sys.argv", ["taylor_expansion.py"])
    runpy.run_path(os.path.join(repo, "examples", "taylor_expansion.py"), run_name="__main__")
    want = capsys.readouterr().out
    taylor_expansion.main()
    got = capsys.readouterr().out
    assert got == want and "order (2, 2):" in got and len(got.splitlines()) == 11
