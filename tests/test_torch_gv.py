"""The port's GV front end against the JAX package's, each reading its own
bundled tables.

- The tables: each of the six bundled directories (and the README) of the
  port is byte for byte the JAX package's; the port unpacks five of them
  from ``tables/groups.tar.xz`` at first use.
- The cases of ``tests/test_gv.py`` and ``tests/test_bundled_tables.py``
  (the Graph and FeynmanGraph reader paths, Vertex4 and Vertex4I, and the
  counterterm equivalences: ``taylorexpansion_feynman`` of the order-n
  diagrams against the tabulated counterterm files), run in both packages
  (``pkg``); the port's numbers must equal the reference's exactly, since
  both are the same host arithmetic on the same tables.
- The pipeline: GV Σ and charge polarization at orders 1-4, read, optimized
  and lowered by each package, give identical lowered tables and leaf
  tables (tolerance none), and the roots of both packages' compiled
  evaluators agree in float64 within rtol 1e-12 + 1e-12·max|ref| per root at
  batch 16 (the reference's derivative tower differs from the port's closed
  form in the last digits).  The JAX package's own pipeline tests of GV
  tables (``tests/test_end_to_end.py``) skip without ``FDTPU_GV_TABLES``;
  these read each package's bundled tables and do not skip.
"""
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_host import PORT, REF, assert_same_lowering, leaf_tables_with, lower_with  # noqa: E402

PKGS = [REF, PORT]
BETA, KF, LAM = 0.5, 1.919, 1.0


def gv_of(pkg):
    return importlib.import_module(f"{pkg}.frontends.gv")


@pytest.fixture(autouse=True)
def _bundled_tables(monkeypatch):
    """Both packages read their own bundled tables, whatever the
    environment says."""
    for pkg in PKGS:
        monkeypatch.setattr(gv_of(pkg), "_TABLE_PATH", None)


def table_dir(pkg):
    gv = gv_of(pkg)
    if pkg == PORT:
        return importlib.import_module(f"{PORT}.frontends.gv.gv").unpack_bundled_tables()
    return os.path.join(os.path.dirname(gv.__file__), "tables")


@pytest.mark.parametrize("name", ["groups_charge", "groups_free_energy", "groups_green",
                                  "groups_sigma", "groups_spin", "groups_vertex4",
                                  "README.md"])
def test_tables_byte_identical(name):
    ref, port = os.path.join(table_dir(REF), name), os.path.join(table_dir(PORT), name)
    if name.endswith(".md"):
        files = [""]
    else:
        files = sorted(os.listdir(ref))
        assert sorted(os.listdir(port)) == files and files
    for f in files:
        with open(os.path.join(ref, f) if f else ref, "rb") as a, \
                open(os.path.join(port, f) if f else port, "rb") as b:
            assert a.read() == b.read(), f


def test_unpacking_is_idempotent_and_atomic(monkeypatch, tmp_path):
    """Unpacking into an empty ``tables/`` makes every packed directory,
    leaves no scratch directory behind, and a second call changes
    nothing."""
    gv_mod = importlib.import_module(f"{PORT}.frontends.gv.gv")
    monkeypatch.setattr(gv_mod, "_BUNDLED", str(tmp_path))
    assert gv_mod.unpack_bundled_tables() == str(tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted(gv_mod.PACKED_GROUPS)
    before = {d: sorted(os.listdir(tmp_path / d)) for d in gv_mod.PACKED_GROUPS}
    gv_mod.unpack_bundled_tables()
    assert {d: sorted(os.listdir(tmp_path / d)) for d in gv_mod.PACKED_GROUPS} == before


def test_missing_table_names_a_module_that_exists(monkeypatch, tmp_path):
    gv_mod = importlib.import_module(f"{PORT}.frontends.gv.gv")
    monkeypatch.setattr(gv_mod, "_BUNDLED", str(tmp_path))
    with pytest.raises(FileNotFoundError) as err:
        gv_mod.diagsGV("sigma", 9)
    module = str(err.value).split("python -m ")[1].strip()
    assert module == f"{PORT}.frontends.gv.generator"
    assert importlib.util.find_spec(module) is not None


# -- tests/test_gv.py and tests/test_bundled_tables.py, in both packages ----

def eval_all(pkg, graphs):
    cg = importlib.import_module(f"{pkg}.computational_graph")
    return [cg.eval_graph(g) for g in graphs]


def reader_results(pkg):
    """What the reader cases of tests/test_gv.py check, as plain data."""
    gv = gv_of(pkg)
    common = importlib.import_module(f"{pkg}.frontends.common")
    sigma2 = gv.diagsGV("sigma", 2)
    polar2 = gv.diagsGV("chargePolar", 2)
    ver4i = gv.diagsGV_ver4(3, channels=[common.Alli])
    ver4 = gv.diagsGV_ver4(1)
    graphs, _, ext_ts = gv.diagsGV("sigma", 2, 0, 0)
    sigma3 = gv.diagsGV("sigma", 3)
    return {"sigma2_extT": sorted(g.properties.extT for g in sigma2),
            "sigma2": eval_all(pkg, sigma2),
            "polar2": eval_all(pkg, polar2),
            "ver4i_responses": [str(g.properties.response) for g in ver4i],
            "ver4i": eval_all(pkg, ver4i), "ver4": eval_all(pkg, ver4),
            "feynman_ext_ts": [tuple(t) for t in ext_ts], "feynman": eval_all(pkg, graphs),
            "sigma3": eval_all(pkg, sigma3)}


@pytest.mark.parametrize("pkg", PKGS)
def test_reader_cases(pkg):
    r = reader_results(pkg)
    common = importlib.import_module(f"{pkg}.frontends.common")
    assert set(r["sigma2_extT"]) == {(1, 2), (1, 1)}
    assert len(r["polar2"]) == 1 and r["polar2"][0] != 0
    assert r["ver4i"] and r["ver4i_responses"][:2] == [str(common.UpUp), str(common.UpDown)]
    assert r["ver4"]
    assert len(r["feynman"]) == len(r["feynman_ext_ts"]) == 2
    assert r["feynman_ext_ts"][0][0] == r["feynman_ext_ts"][0][1]
    assert all(np.isfinite(r["sigma3"])) and any(v != 0 for v in r["sigma3"])
    if pkg == PORT:
        assert r == reader_results(REF)


def counterterm_values(pkg, kind, orders, var_orders):
    """(AD coefficient value, tabulated value) for the first two graphs of
    each counterterm file of ``orders``: the contract of FeynmanDiagram.jl's
    taylor.jl:97-113."""
    gv = gv_of(pkg)
    taylor = importlib.import_module(f"{pkg}.taylor")
    utility = importlib.import_module(f"{pkg}.utility")
    cg = importlib.import_module(f"{pkg}.computational_graph")
    dict_g = {o: gv.diagsGV(kind, *o)[0] for o in orders}
    taylor.set_variables("x y", orders=var_orders)
    tvec, _ = utility.taylorexpansion_feynman(dict_g[orders[0]],
                                              ([True, False], [False, True]))
    out = []
    for order, graphs in dict_g.items():
        key = (order[1], order[2])
        for i in range(min(2, len(graphs))):
            out.append((order, i, cg.eval_graph(tvec[i].coeffs[key]),
                        cg.eval_graph(graphs[i])))
    return out


COUNTERTERMS = {
    "sigma2": ("sigma", [(2, 0, 0), (2, 0, 1), (2, 0, 2), (2, 1, 0), (2, 1, 1), (2, 2, 0),
                         (2, 1, 2), (2, 2, 2)], [2, 2]),
    "sigma3": ("sigma", [(3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1), (3, 2, 0), (3, 0, 2),
                         (3, 2, 1)], [3, 3]),
    "sigma4": ("sigma", [(4, 0, 0), (4, 1, 0), (4, 0, 1), (4, 1, 1), (4, 2, 0), (4, 0, 2)],
               [2, 2]),
    "polar3": ("chargePolar", [(3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1), (3, 2, 0),
                               (3, 0, 2)], [3, 3]),
    "bundled_sigma2": ("sigma", [(2, 0, 0), (2, 0, 1), (2, 1, 0), (2, 1, 1)], [2, 2]),
    "bundled_sigma3": ("sigma", [(3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1), (3, 2, 0)],
                       [3, 3]),
}


@pytest.fixture(scope="module")
def counterterms():
    """Each package's counterterm values of a case, computed once."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            cache[pkg, case] = counterterm_values(pkg, *COUNTERTERMS[case])
        return cache[pkg, case]

    return get


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", sorted(COUNTERTERMS))
def test_counterterm_equivalence(counterterms, pkg, case):
    values = counterterms(pkg, case)
    assert values
    for order, i, got, expected in values:
        assert got == pytest.approx(expected), (order, i)
    if pkg == PORT:
        assert values == counterterms(REF, case)


# -- GV graphs through each package's pipeline ------------------------------

def gv_pipeline(pkg, kind, order):
    """``(roots, max_loop_num, num_tau)`` of GV ``kind`` at ``order``, read
    from ``pkg``'s bundled tables and optimized at level 1."""
    cg = importlib.import_module(f"{pkg}.computational_graph")
    compile_mod = importlib.import_module(f"{pkg}.backends.compile")
    roots = list(gv_of(pkg).diagsGV(kind, order))
    ids = [leaf.properties for leaf in compile_mod.leaf_graphs_of(roots).values()]
    max_loop = max(len(p.extK) for p in ids)
    num_tau = max(max(p.extT) for p in ids)
    cg.optimize_inplace(roots, level=1)
    return roots, max_loop, num_tau


GV_CASES = [(k, o) for k in ("sigma", "chargePolar") for o in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def gv_generated():
    cache = {}

    def get(kind, order):
        if (kind, order) not in cache:
            cache[kind, order] = (gv_pipeline(REF, kind, order), gv_pipeline(PORT, kind, order))
        return cache[kind, order]

    return get


@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
@pytest.mark.parametrize("kind,order", GV_CASES)
def test_gv_lowerings_and_leaf_tables_identical(gv_generated, kind, order, sum_mode):
    (ref_roots, max_loop, _), (port_roots, port_loop, _) = gv_generated(kind, order)
    assert max_loop == port_loop == order + 1
    low_p = lower_with(PORT, port_roots, sum_mode=sum_mode, cse=True)
    low_r = lower_with(REF, ref_roots, sum_mode=sum_mode, cse=True)
    assert_same_lowering(low_p, low_r)
    tab_p = leaf_tables_with(PORT, port_roots, low_p, max_loop)
    tab_r = leaf_tables_with(REF, ref_roots, low_r, max_loop)
    for name in ("leaf_type", "g_order", "v_order", "tau_in", "tau_out", "loop_idx",
                 "loop_basis"):
        x, y = getattr(tab_p, name), getattr(tab_r, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("kind,order", GV_CASES)
def test_gv_roots_match_jax(gv_generated, kind, order):
    from feynmandiagram_tpu.backends import compile as jax_compile
    from feynmandiagram_tpu_torch.backends import compile as port_compile
    (ref_roots, max_loop, num_tau), (port_roots, _, _) = gv_generated(kind, order)
    rng = np.random.default_rng(100 + order)
    varK = rng.standard_normal((3, max_loop, 16))
    varT = rng.random((num_tau, 16)) * BETA
    kw = dict(max_loop_num=max_loop, beta=BETA, kF=KF, lam=LAM)
    ref = np.asarray(jax_compile.compile_evaluator(ref_roots, dtype=np.float64, layout="flat",
                                                   **kw)(varK, varT))
    got = port_compile.compile_evaluator(port_roots, device="cpu", dtype=torch.float64,
                                         **kw)(varK, varT).numpy()
    assert got.shape == ref.shape == (len(ref_roots), 16)
    for r in range(len(ref)):
        np.testing.assert_allclose(got[r], ref[r], rtol=1e-12,
                                   atol=1e-12 * np.abs(ref[r]).max())
