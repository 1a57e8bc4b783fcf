"""Gamma4 at the orders beside the main path's order 4, on the CPU.

- The column-window check of the passes whose weight buffer passes 2^31
  elements on the card (``benchmarks/gamma4_orders.differing_rows``), at
  order 3: a graph pass on three narrow windows of the leaf values gives
  the full pass's rows in those columns bit for bit, fused and bucketed.
- The artifact route of the large orders (``export_artifact`` ->
  ``load_artifact`` -> ``make_leaf_evaluator`` + ``make_evaluator``) against
  ``compile_evaluator`` at order 3, bit for bit, and the host builds of
  ``gamma4_orders.export_orders`` (one forked process an artifact).
- Order 5, ``slow`` (generation takes minutes): the lowerings and the leaf
  tables identical in both packages (no tolerance: integer tables and
  copied factors), and ``compile_evaluator``'s roots in float64 against the
  JAX package's on the same numpy samples within rtol 1e-12 plus
  1e-12 * max|ref| per root (the config-4 tests' tolerance: the JAX
  package's nested ``jax.grad`` G tower is off by up to 2e-10 relative at
  order 5, the port's closed form by 5e-14, so the tolerance has an
  absolute part of each root's scale).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends import compile as jax_compile  # noqa: E402
from feynmandiagram_tpu_torch.backends import compile as port  # noqa: E402
from feynmandiagram_tpu_torch.benchmarks import gamma4_orders as g4  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.leaf_eval import make_leaf_evaluator  # noqa: E402

from test_torch_host import (PORT, REF, assert_same_lowering, generate,  # noqa: E402
                             leaf_tables_with, lower_with)

BETA, KF, LAM = 0.5, 1.919, 1.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _samples(para, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, para.totalLoopNum, batch)),
            rng.random((para.totalTauNum, batch)) * BETA)


@pytest.fixture(scope="module")
def order3():
    roots, para = g4.vertex4_roots(3)
    return roots, para


@pytest.mark.parametrize("batch,width", [(64, 16), (48, 16)])
@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
def test_column_windows_equal_the_full_pass_bit_for_bit(order3, sum_mode, batch, width):
    roots, para = order3
    c = port.compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                               lam=LAM, device="cpu", dtype=torch.float32, sum_mode=sum_mode)
    graph_all = make_evaluator(c.lowered, device="cpu", dtype=torch.float32, return_all=True)
    leaves = c.leaf_fn(*_samples(para, batch, 11))
    w = graph_all(leaves)
    assert w.shape == (c.lowered.num_slots, batch) and torch.isfinite(w).all()
    assert g4.differing_rows(graph_all, leaves, w, width) == [0, 0, 0]
    # the check sees a difference in one bit of one row of one window
    w[c.lowered.root_slots[0], batch - 1] = torch.nextafter(
        w[c.lowered.root_slots[0], batch - 1], torch.tensor(np.inf, dtype=w.dtype))
    assert g4.differing_rows(graph_all, leaves, w, width) == [0, 0, 1]


def test_column_windows():
    assert g4.column_windows(64, 16) == [slice(0, 16), slice(32, 48), slice(48, 64)]
    assert g4.column_windows(65536, 512) == [slice(0, 512), slice(32768, 33280),
                                             slice(65024, 65536)]
    assert g4.column_windows(16, 16) == [slice(0, 16)] * 3
    with pytest.raises(ValueError):
        g4.column_windows(8, 16)


@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
def test_order3_artifact_evaluates_as_compile_evaluator(order3, tmp_path, sum_mode):
    roots, para = order3
    path = str(tmp_path / f"o3_{sum_mode}.npz")
    secs = port.export_artifact(path, roots, max_loop_num=para.totalLoopNum,
                                sum_mode=sum_mode, cse=True)
    assert set(secs) == {"lower_s", "tables_s", "save_s"} and min(secs.values()) >= 0
    lowered, tables = port.load_artifact(path)
    leaf_fn = make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM, device="cpu",
                                  dtype=torch.float64)
    graph_fn = make_evaluator(lowered, device="cpu", dtype=torch.float64)
    c = port.compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                               lam=LAM, device="cpu", dtype=torch.float64, sum_mode=sum_mode)
    varK, varT = _samples(para, 16, 5)
    got, want = graph_fn(leaf_fn(varK, varT)), c(varK, varT)
    assert got.shape == (84, 16) and torch.equal(got, want)
    assert (lowered.num_slots, lowered.num_edges) == (c.lowered.num_slots, c.lowered.num_edges)


def test_export_orders_writes_every_artifact(tmp_path):
    """The host build as chip_smoke starts it: a child process, jax and
    the JAX package blocked, one forked process an artifact; its last line
    is JSON, and each artifact loads."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['feynmandiagram_tpu'] = None; "
            "from feynmandiagram_tpu_torch.benchmarks.gamma4_orders import main; main()")
    proc = subprocess.run([sys.executable, "-c", code, "3", str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    done = json.loads(lines[-1])
    assert sorted(done["paths"]) == sorted(g4.ARTIFACTS)
    assert any("leaf tables in" in line for line in lines)
    for name, path in done["paths"].items():
        lowered, tables = port.load_artifact(path)
        assert len(lowered.root_slots) == 84 and tables.num_leaves == 179, name
    with pytest.raises(ValueError, match="unknown"):
        g4.export_orders(3, str(tmp_path), ["csr"])


@pytest.fixture(scope="module")
def order5():
    """Order-5 Gamma4 from each package: (JAX roots, port roots, para)."""
    roots, para = generate(REF, "vertex4", 5)
    return roots, generate(PORT, "vertex4", 5)[0], para


@pytest.mark.slow
@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
def test_order5_lowering_and_leaf_tables_identical(order5, sum_mode):
    ref_roots, port_roots, para = order5
    low_p = lower_with(PORT, port_roots, sum_mode=sum_mode, cse=True)
    low_r = lower_with(REF, ref_roots, sum_mode=sum_mode, cse=True)
    assert_same_lowering(low_p, low_r)
    assert low_p.num_edges == {"fused": 272806, "bucketed": 342953}[sum_mode]
    tab_p = leaf_tables_with(PORT, port_roots, low_p, para.totalLoopNum)
    tab_r = leaf_tables_with(REF, ref_roots, low_r, para.totalLoopNum)
    for f in dataclasses.fields(tab_r):
        x, y = getattr(tab_p, f.name), getattr(tab_r, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name
    assert tab_p.loop_basis.shape == (1097, para.totalLoopNum)


@pytest.mark.slow
@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
def test_order5_compile_evaluator_matches_jax(order5, sum_mode):
    ref_roots, port_roots, para = order5
    varK, varT = _samples(para, 8, 9)
    kw = dict(max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM, sum_mode=sum_mode)
    ref = np.asarray(jax_compile.compile_evaluator(ref_roots, dtype=np.float64, layout="flat",
                                                   **kw)(varK, varT))
    got = port.compile_evaluator(port_roots, device="cpu", dtype=torch.float64, **kw)(
        varK, varT).numpy()
    assert got.shape == ref.shape == (330, 8) and np.isfinite(ref).all()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12 * np.abs(r).max())
