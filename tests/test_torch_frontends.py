"""The port's Parquet front end against the JAX package's, case by case as
``tests/test_parquet.py`` and ``tests/test_rpa_chain.py`` check the
reference.

Each case runs in both packages (``pkg``): the port's copies of
``parquet/sigma.py``, ``green.py``, ``vertex3.py``, ``polarization.py``,
``sigma_gv.py``, ``ep_coupling.py``, ``vertex4.py`` (``rpa_chain``) and
``parquet/benchmark/`` against the closed-form diagram counts and pinned
values those files hold, and, for the port, its numbers against the
reference's on the same case: exactly where both are the same host
arithmetic (leaf == 1 sums, bookkeeping), within rtol 1e-12 where a case
evaluates physical leaves through each package's evaluator in float64.
"""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_host import PORT, REF  # noqa: E402

PKGS = [REF, PORT]


def m(pkg, name=""):
    return importlib.import_module(f"{pkg}.{name}" if name else pkg)


def fe(pkg):
    return m(pkg, "frontends")


def pq(pkg):
    return m(pkg, "frontends.parquet")


def eval_graph(pkg, g, *args):
    return m(pkg, "computational_graph").eval_graph(g, *args)


def both(pkg, fn, *args):
    """``fn(pkg, *args)``; for the port also the reference's result, which
    must be equal."""
    got = fn(pkg, *args)
    if pkg == PORT:
        assert got == fn(REF, *args)
    return got


# -- bookkeeping and filters ------------------------------------------------

def bookkeeping(pkg):
    p = pq(pkg)
    types = [p.Ver4Diag, p.GreenDiag, p.Ver4Diag, p.GreenDiag]
    return (sorted(map(tuple, p.ordered_partition(5, 2))),
            sorted(map(tuple, p.ordered_partition(3, 2, 0))),
            p.find_first_loop_idx([1, 1, 2, 1], 1), p.find_first_loop_idx([1, 0, 2, 0], 1),
            p.find_first_tau_idx([1, 1, 2, 1], types, 1, 1),
            p.find_first_tau_idx([1, 0, 2, 0], types, 1, 1))


@pytest.mark.parametrize("pkg", PKGS)
def test_bookkeeping(pkg):
    parts, parts0, l1, l2, t1, t2 = both(pkg, bookkeeping)
    assert parts == [(1, 4), (2, 3), (3, 2), (4, 1)]
    assert parts0 == [(0, 3), (1, 2), (2, 1), (3, 0)]
    assert l1 == ([1, 2, 3, 5], 5) and l2 == ([1, 2, 2, 4], 3)
    assert t1 == ([1, 3, 4, 7], 7) and t2 == ([1, 3, 3, 6], 5)


def filters(pkg):
    p, f = pq(pkg), fe(pkg)
    return ([p.is_valid_g([f.NoFock, f.NoHartree], 1), p.is_valid_g([f.NoFock], 1),
             p.is_valid_g([f.Girreducible], 1), p.is_valid_g([f.Girreducible], 0),
             p.is_valid_g([], 2)],
            [p.is_valid_sigma([], 0, False), p.is_valid_sigma([f.Girreducible], 1, True),
             p.is_valid_sigma([f.Girreducible], 1, False),
             p.is_valid_sigma([f.NoFock, f.NoHartree], 1, True),
             p.is_valid_sigma([f.NoFock, f.NoHartree], 1, False),
             p.is_valid_sigma([], 2, True)])


@pytest.mark.parametrize("pkg", PKGS)
def test_filters(pkg):
    g, s = both(pkg, filters)
    assert g == [False, True, False, True, True]
    assert s == [False, False, True, False, True, True]


# -- diagram counts (arXiv:cond-mat/0512342) --------------------------------

def sigma_para(pkg, loop_num, spin=2):
    p, f = pq(pkg), fe(pkg)
    return p.DiagPara(type=p.SigmaDiag, hasTau=True, innerLoopNum=loop_num,
                      totalLoopNum=loop_num + 1, totalTauNum=loop_num, isFermi=False,
                      spin=spin, firstLoopIdx=2, firstTauIdx=1,
                      filter=(f.NoHartree, f.Girreducible),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))


def sigma_root(pkg, l):
    p = pq(pkg)
    if l >= 4:      # order 4 needs the fully irreducible vertex tables
        v4 = m(pkg, "frontends.parquet.vertex4")
        if not v4.get_ver4I():
            v4.initialize_vertex4I_diags()
    para = sigma_para(pkg, l)
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    return p.mergeby(p.sigma(para, extK, False))[0]["diagram"], para


def sigma_count(pkg, l):
    root, para = sigma_root(pkg, l)
    return eval_graph(pkg, root) * (-1) ** para.innerLoopNum, para.spin


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_sigma_G2v(pkg, l):
    w, spin = both(pkg, sigma_count, l)
    assert w == pytest.approx(pq(pkg).benchmark.count_sigma_G2v(l, spin))


def sigma_count_lowered(pkg, l):
    ops = m(pkg, "ops")
    root, para = sigma_root(pkg, l)
    lowered = ops.lower([root])
    ones = np.ones((lowered.num_leaves - len(lowered.const_slots), 1))
    kw = {"device": "cpu"} if pkg == PORT else {}
    out = np.asarray(ops.make_evaluator(lowered, **kw)(ones))
    return float(out[0, 0]) * (-1) ** l, para.spin


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("l", [1, 2, 3])
def test_sigma_G2v_lowered(pkg, l):
    """The same count through each package's lowering and evaluator."""
    w, spin = both(pkg, sigma_count_lowered, l)
    assert w == pytest.approx(pq(pkg).benchmark.count_sigma_G2v(l, spin))


def green_built(pkg):
    p, f = pq(pkg), fe(pkg)

    def build(loop_num, filt):
        para = p.DiagPara(type=p.GreenDiag, hasTau=True, innerLoopNum=loop_num, isFermi=True,
                          spin=2, filter=tuple(filt),
                          interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        return p.green(para, extK, (1, 2)) is not None if p.is_valid_g(para) else False

    return ([build(n, [f.NoHartree, f.Girreducible]) for n in (0, 1, 2)],
            [build(n, [f.NoHartree, f.NoFock]) for n in (0, 1, 2)])


@pytest.mark.parametrize("pkg", PKGS)
def test_green_filters(pkg):
    girr, nofock = both(pkg, green_built)
    assert girr == [True, False, False] and nofock == [True, False, True]


def ver3_count(pkg, l):
    p, f = pq(pkg), fe(pkg)
    para = p.DiagPara(type=p.Ver3Diag, innerLoopNum=l, isFermi=False, hasTau=True,
                      filter=(f.NoHartree, f.Girreducible, f.Proper),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
    K0 = np.zeros(para.totalLoopNum)
    KinL, Q = K0.copy(), K0.copy()
    Q[0] = 1
    KinL[1] = 1
    merged = p.mergeby(p.vertex3(para, [Q, KinL]))
    return eval_graph(pkg, merged[0]["diagram"]) * (-1) ** l, para.spin


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("l", [1, 2, 3])
def test_ver3_G2v(pkg, l):
    w, spin = both(pkg, ver3_count, l)
    assert w == pytest.approx(pq(pkg).benchmark.count_ver3_G2v(l, spin))


def polar_counts(pkg, l, filter_names, first_row):
    p, f = pq(pkg), fe(pkg)
    para = p.DiagPara(type=p.PolarDiag, innerLoopNum=l, isFermi=False, hasTau=True,
                      filter=tuple(getattr(f, n) for n in filter_names),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
    Q = np.zeros(para.totalLoopNum)
    Q[0] = 1
    rows = p.polarization(para, Q)
    if first_row:
        assert rows[0]["response"] == f.UpUp
        w = eval_graph(pkg, rows[0]["diagram"])
    else:
        w = eval_graph(pkg, p.mergeby(rows)[0]["diagram"])
    return w * para.spin * (-1) ** (l - 1), para.spin


POLAR = {"G2v": (("NoHartree", "Girreducible"), False, "count_polar_G2v"),
         "g2v_noFock": (("NoHartree", "NoFock"), False, "count_polar_g2v_noFock"),
         "g2v_noFock_upup": (("NoHartree", "NoFock"), True, "count_polar_g2v_noFock_upup")}


@pytest.mark.parametrize("pkg", PKGS)
def test_polar_explicit_proper(pkg):
    p, f = pq(pkg), fe(pkg)
    para = p.DiagPara(type=p.PolarDiag, innerLoopNum=1, isFermi=False, hasTau=True,
                      filter=(f.Proper, f.NoHartree, f.NoFock),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
    Q = np.zeros(para.totalLoopNum)
    Q[0] = 1
    p.polarization(para, Q)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", sorted(POLAR))
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_polar_counts(pkg, case, l):
    filter_names, first_row, count = POLAR[case]
    w, spin = both(pkg, polar_counts, l, filter_names, first_row)
    assert w == pytest.approx(getattr(pq(pkg).benchmark, count)(l, spin))


# -- sigmaGV, ep_coupling, taylorAD against forward AD -----------------------

def sigma_gv_rows(pkg):
    p, f = pq(pkg), fe(pkg)
    para = p.DiagPara(type=p.SigmaDiag, innerLoopNum=1, hasTau=True, filter=(f.NoHartree,),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    return [eval_graph(pkg, row["diagram"]) for row in p.sigmaGV(para, extK, False)]


@pytest.mark.parametrize("pkg", PKGS)
def test_sigma_gv_runs(pkg):
    vals = both(pkg, sigma_gv_rows)
    assert len(vals) >= 1 and all(np.isfinite(vals))


def ep_coupling_values(pkg, l):
    p, f = pq(pkg), fe(pkg)
    para = p.DiagPara(type=p.Ver4Diag, hasTau=True, innerLoopNum=l,
                      interaction=(p.Interaction(f.ChargeCharge, [f.Instant, f.Dynamic]),))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rows = p.ep_coupling(para)
    return [eval_graph(pkg, r["diagram"]) for r in rows]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("l,want", [(1, -8.0), (2, 64.0)])
def test_ep_coupling_values(pkg, l, want):
    """Leaf == 1 sums of the electron-phonon vertex: order 1 derived in
    closed form, order 2 pinned (tests/test_parquet.py)."""
    vals = both(pkg, ep_coupling_values, l)
    assert len(vals) >= 1 and all(np.isfinite(vals))
    assert sum(vals) == pytest.approx(want)


def taylor_vs_forward_ad(pkg):
    p, f = pq(pkg), fe(pkg)
    utility, cg = m(pkg, "utility"), m(pkg, "computational_graph")
    para = p.DiagPara(type=p.SigmaDiag, innerLoopNum=2, hasTau=True, filter=(f.NoHartree,),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    root = p.mergeby(p.sigma(para, extK, False))[0]["diagram"]
    rng = np.random.default_rng(7)
    leafmap, vals = {}, []
    for leaf in root.leaves():
        if leaf.id not in leafmap:
            leafmap[leaf.id] = len(vals)
            vals.append(rng.uniform(0.5, 1.5))
    coeff = utility.taylorAD([root], [1], [lambda q: isinstance(q, f.BareGreenId)])[(1,)][0]
    cmap, cvals = dict(leafmap), list(vals)
    for leaf in coeff.leaves():
        if leaf.id not in cmap:
            cmap[leaf.id] = len(cvals)
            cvals.append(1.0)
    got = cg.eval_graph(coeff, cmap, cvals)
    expected = 0.0
    for uid in leafmap:
        leaf = next(x for x in root.leaves() if x.id == uid)
        if isinstance(leaf.properties, f.BareGreenId):
            d = cg.forward_ad(root, uid)
            if isinstance(d, (int, float)):
                expected += d
            else:
                dmap, dvals = dict(leafmap), list(vals)
                for x in d.leaves():
                    if x.id not in dmap:
                        dmap[x.id] = len(dvals)
                        dvals.append(x.weight if x.operator.kind == "unitary" else 0.0)
                expected += cg.eval_graph(d, dmap, dvals)
    return got, expected


@pytest.mark.parametrize("pkg", PKGS)
def test_taylor_first_order_equals_forward_ad_sum(pkg):
    got, expected = taylor_vs_forward_ad(pkg)
    assert got == pytest.approx(expected, rel=1e-9)
    if pkg == PORT:
        ref_got, ref_expected = taylor_vs_forward_ad(REF)
        assert got == pytest.approx(ref_got, rel=1e-12)
        assert expected == pytest.approx(ref_expected, rel=1e-12)


def sigma_gv_vs_sigma(pkg, l):
    """Rows of sigmaGV and of sigma by extT, through each package's
    compile_evaluator on the same physical samples, float64."""
    p, f = pq(pkg), fe(pkg)
    compile_mod = m(pkg, "backends.compile")
    para = p.DiagPara(type=p.SigmaDiag, innerLoopNum=l, hasTau=True, filter=(f.NoHartree,),
                      interaction=(p.Interaction(f.ChargeCharge, f.Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    rng = np.random.default_rng(0)
    varK = rng.standard_normal((3, para.totalLoopNum, 4))
    varT = rng.random((para.totalLoopNum, 4)) * 0.5
    kw = {"device": "cpu", "dtype": torch.float64} if pkg == PORT else {"dtype": np.float64}

    def rows_by_extT(fn):
        rows = fn(para, extK, False)
        c = compile_mod.compile_evaluator([r["diagram"] for r in rows],
                                          max_loop_num=para.totalLoopNum, beta=0.5,
                                          kF=1.919, lam=1.0, **kw)
        out = np.asarray(c(varK, varT))
        return {tuple(r["extT"]): out[i] for i, r in enumerate(rows)}

    return rows_by_extT(p.sigma), rows_by_extT(p.sigmaGV)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("l", [1, 2])
def test_sigma_gv_instant_rows_agree_with_sigma(pkg, l):
    s, gvr = sigma_gv_vs_sigma(pkg, l)
    for t, v in gvr.items():
        assert t in s
        np.testing.assert_allclose(v, s[t], rtol=1e-10)
    assert all(t[0] == t[1] for t in gvr)
    if pkg == PORT:
        ref_s, ref_gv = sigma_gv_vs_sigma(REF, l)
        for mine, ref in ((s, ref_s), (gvr, ref_gv)):
            assert set(mine) == set(ref)
            for t in ref:
                np.testing.assert_allclose(mine[t], ref[t], rtol=1e-12,
                                           atol=1e-12 * np.abs(ref[t]).max())


# -- tests/test_rpa_chain.py -------------------------------------------------

def rpa_weights(pkg, chan_name):
    p, f = pq(pkg), fe(pkg)
    common = m(pkg, "frontends.parquet.common")
    v4 = m(pkg, "frontends.parquet.vertex4")
    loopnum = 3
    para = p.DiagPara(type=p.Ver4Diag, hasTau=True, innerLoopNum=loopnum,
                      interaction=(p.Interaction(f.ChargeCharge, [f.Instant, f.Dynamic]),))
    legK1, legK2, legK3 = (common.get_k(para.totalLoopNum, i) for i in (1, 2, 3))
    extK = [legK1, legK2, legK3, legK1 + legK3 - legK2]
    ver4df = []
    v4.rpa_chain(ver4df, para, extK, getattr(f, chan_name), 0, "RPA", -1.0)
    return [eval_graph(pkg, row["diagram"]) for row in p.mergeby(ver4df, ["response"])]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("chan,w_upup,w_updown", [("PHEr", -1, 0.0), ("PHr", +1, 1.0)])
def test_rpa_chain_weights(pkg, chan, w_upup, w_updown):
    """Each bubble contributes 2 and each dynamic interaction 2; exchange
    adds a minus sign and forbids up-down (FeynmanDiagram.jl
    front_end.jl:398-443)."""
    w = both(pkg, rpa_weights, chan)
    weight = (2 ** 3) * (2 ** 4)
    assert w[0] == pytest.approx(w_upup * weight)
    assert w[1] == pytest.approx(w_updown * weight)
