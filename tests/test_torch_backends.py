"""The port's source and DOT exports (``backends.source``,
``backends.to_dot``) against the JAX package's, case by case as
``tests/test_backends.py`` checks the reference.

Each case runs in both packages (``pkg``) on the same small graph, built
from a fresh uid counter in each.  The Python export's values are held to
the host interpreter (``eval_graph``) in float64 within rtol 1e-12; the
port's ``framework="torch"`` export to the JAX package's ``"jax"`` export
on the same ``leafVal`` in float64 within rtol 1e-12 (the same arithmetic
in the same order; XLA may contract a multiply and an add); the Julia, C
and DOT texts must be identical; the C export is compiled with gcc and run
through ctypes.  On a real graph (GV Σ at order 3, optimized) the torch
export is a third evaluation beside the port's evaluator, in float64,
within rtol 1e-12 + 1e-12·max|root| per root.  ``to_stablehlo`` raises in the port.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_host import PORT, REF  # noqa: E402

PKGS = [REF, PORT]


def backends(pkg):
    return importlib.import_module(f"{pkg}.backends")


def example(pkg):
    """tests/test_backends.py's two roots, from a fresh uid counter."""
    cg = importlib.import_module(f"{pkg}.computational_graph")
    cg.uid_reset()
    x = cg.Graph([], properties="x")
    y = cg.Graph([], properties="y")
    s = cg.Graph([x, y], subgraph_factors=[2.0, 3.0], operator=cg.SUM)
    p = cg.Graph([s, x], subgraph_factors=[1.0, -1.0], operator=cg.PROD)
    pw = cg.Graph([s], subgraph_factors=[0.5], operator=cg.Power(3))
    root1 = cg.Graph([p, pw], subgraph_factors=[1.0, 2.0], operator=cg.SUM)
    return [root1, s], x, y


def interpreted(pkg, roots, leafmap, vals):
    cg = importlib.import_module(f"{pkg}.computational_graph")
    vec = [vals[u] for u, _ in sorted(leafmap.items(), key=lambda kv: kv[1])]
    return [cg.eval_graph(r, leafmap, vec) for r in roots]


@pytest.mark.parametrize("pkg", PKGS)
def test_python_export_matches_interpreter(pkg):
    roots, x, y = example(pkg)
    fn, leafmap = backends(pkg).compile_python(roots, framework="numpy")
    vals = {x.id: 1.3, y.id: -0.7}
    leaf_arr = np.zeros((len(leafmap), 4))
    for uid, idx in leafmap.items():
        leaf_arr[idx] = vals[uid]
    out = fn(leaf_arr)
    np.testing.assert_allclose(out[:, 0], interpreted(pkg, roots, leafmap, vals), rtol=1e-12)


def test_torch_export_matches_jax_export():
    """The port's default export (torch) against the JAX package's default
    (jax) on the same leafVal, and the port's numpy export against both."""
    rng = np.random.default_rng(0)
    ref_roots, *_ = example(REF)
    ref_fn, ref_map = backends(REF).compile_python(ref_roots)
    roots, *_ = example(PORT)
    fn, leafmap = backends(PORT).compile_python(roots)
    np_fn, np_map = backends(PORT).compile_python(roots, framework="numpy")
    assert leafmap == ref_map == np_map and len(leafmap) == 2
    leaf_val = rng.uniform(-2.0, 2.0, (len(leafmap), 16))
    want = np.asarray(ref_fn(leaf_val))
    got = fn(torch.as_tensor(leaf_val))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(np_fn(leaf_val), want, rtol=1e-12)
    src, _ = backends(PORT).to_python_str(roots)
    assert src.startswith("import torch\n") and "torch.stack([" in src
    assert "jax" not in src


@pytest.mark.parametrize("pkg", PKGS)
def test_julia_export_structure(pkg):
    roots, *_ = example(pkg)
    src, _ = backends(pkg).to_julia_str(roots)
    assert src.startswith("function eval_graph!")
    assert "root[1]" in src and "root[2]" in src
    assert "leafVal[1]" in src
    if pkg == PORT:
        assert src == backends(REF).to_julia_str(example(REF)[0])[0]


@pytest.mark.parametrize("pkg", PKGS)
def test_c_export_structure(pkg):
    roots, *_ = example(pkg)
    src, _ = backends(pkg).to_c_str(roots)
    assert "#include <math.h>" in src
    assert "pow(" in src
    assert "root[0]" in src
    if pkg == PORT:
        assert src == backends(REF).to_c_str(example(REF)[0])[0]


@pytest.mark.parametrize("pkg", PKGS)
def test_c_export_compiles_and_runs(pkg, tmp_path):
    import ctypes
    import subprocess

    roots, x, y = example(pkg)
    src, leafmap = backends(pkg).to_c_str(roots)
    cfile, sofile = tmp_path / "eval.c", tmp_path / "eval.so"
    cfile.write_text(src)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(cfile), "-o", str(sofile), "-lm"],
                   check=True)
    lib = ctypes.CDLL(str(sofile))
    lib.eval_graph.argtypes = [ctypes.POINTER(ctypes.c_double),
                               ctypes.POINTER(ctypes.c_double)]
    lib.eval_graph.restype = None
    vals = {x.id: 0.9, y.id: 2.1}
    leaf = (ctypes.c_double * len(leafmap))()
    for uid, idx in leafmap.items():
        leaf[idx] = vals[uid]
    out = (ctypes.c_double * len(roots))()
    lib.eval_graph(out, leaf)
    np.testing.assert_allclose(list(out), interpreted(pkg, roots, leafmap, vals), rtol=1e-12)


@pytest.mark.parametrize("pkg", PKGS)
def test_dot_export(pkg, tmp_path):
    roots, *_ = example(pkg)
    dot = backends(pkg).to_dot_str(roots)
    assert dot.startswith("digraph")
    assert dot.rstrip().endswith("}")
    assert "->" in dot
    path = backends(pkg).compile_dot(roots, str(tmp_path / "g.dot"))
    with open(path) as f:
        assert f.read() == dot
    if pkg == PORT:
        assert dot == backends(REF).to_dot_str(example(REF)[0])


@pytest.mark.parametrize("pkg", PKGS)
def test_plot_tree_graphical(pkg, tmp_path):
    roots, *_ = example(pkg)
    cg = importlib.import_module(f"{pkg}.computational_graph")
    out = tmp_path / "tree.png"
    cg.plot_tree_graphical(roots[0], str(out))
    assert out.exists() and out.stat().st_size > 2000


def test_exports_write_files(tmp_path):
    """``compile_python`` with a file name, ``compile_julia`` and
    ``compile_c`` write the texts of ``to_*_str``."""
    roots, *_ = example(PORT)
    b = backends(PORT)
    name, leafmap = b.compile_python(roots, str(tmp_path / "g.py"))
    assert open(name).read() == b.to_python_str(roots)[0]
    for compile_fn, to_str, ext in ((b.compile_julia, b.to_julia_str, "jl"),
                                    (b.compile_c, b.to_c_str, "c")):
        name, lm = compile_fn(roots, str(tmp_path / f"g.{ext}"))
        assert open(name).read() == to_str(roots)[0] and lm == leafmap


def test_unsupported_exports_raise():
    roots, *_ = example(PORT)
    with pytest.raises(NotImplementedError, match="XLA"):
        backends(PORT).to_stablehlo(roots)
    with pytest.raises(ValueError, match="jax"):
        backends(PORT).to_python_str(roots, framework="jax")


def export_leaves(leafmap, eval_leafmap, leaf_values):
    """The export's ``leafVal``: row ``leafmap[uid]`` holds the evaluator's
    leaf row ``eval_leafmap[uid]`` (``backends.compile.leafmap_of``)."""
    order = sorted(leafmap.items(), key=lambda kv: kv[1])
    return leaf_values[[eval_leafmap[uid] for uid, _ in order]]


def test_torch_export_matches_evaluator_on_gv_sigma():
    """GV Σ at order 3, optimized: the torch export and the port's
    evaluator on the same leaf values, float64, within rtol 1e-12 per root."""
    from feynmandiagram_tpu_torch.backends.compile import compile_evaluator, leafmap_of
    from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
    from feynmandiagram_tpu_torch.frontends import gv
    roots = list(gv.diagsGV("sigma", 3))
    optimize_inplace(roots, level=1)
    c = compile_evaluator(roots, max_loop_num=4, beta=0.5, kF=1.919, lam=1.0, device="cpu",
                          dtype=torch.float64)
    rng = np.random.default_rng(5)
    leaves = c.leaf_fn(rng.standard_normal((3, 4, 16)), rng.random((3, 16)) * 0.5)
    fn, leafmap = backends(PORT).compile_python(roots)
    got = fn(export_leaves(leafmap, leafmap_of(roots), leaves))
    want = c.graph_fn(leaves)
    assert got.shape == want.shape == (len(roots), 16)
    for r in range(len(roots)):
        torch.testing.assert_close(got[r], want[r], rtol=1e-12,
                                   atol=1e-12 * want[r].abs().max().item())
