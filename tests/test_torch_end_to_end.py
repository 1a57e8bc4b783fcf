"""The port's whole slice against the JAX package, in float64:
``compile_evaluator`` on order-3 Gamma4, artifacts carried across packages,
a run with jax blocked from import, and the Monte-Carlo protocol."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends import compile as jax_compile  # noqa: E402
from feynmandiagram_tpu.computational_graph import optimize_inplace  # noqa: E402
from feynmandiagram_tpu.frontends import ChargeCharge, Instant, NoHartree  # noqa: E402
from feynmandiagram_tpu.frontends.parquet import (DiagPara, Interaction,  # noqa: E402
                                                  SigmaDiag, Ver4Diag, sigma, vertex4)
from feynmandiagram_tpu.ops.evaluator import make_evaluator as jax_make_evaluator  # noqa: E402
from feynmandiagram_tpu.ops.leaf_eval import make_leaf_evaluator as jax_leaf  # noqa: E402
from feynmandiagram_tpu_torch.backends import compile as port  # noqa: E402
from feynmandiagram_tpu_torch.mc import mc_run, mc_samples_per_s  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.leaf_eval import make_leaf_evaluator  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vertex4(order):
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [r["diagram"] for r in vertex4(para)]
    optimize_inplace(roots, level=1)
    return roots, para


def _sigma2():
    para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    roots = [r["diagram"] for r in sigma(para, extK, False)]
    optimize_inplace(roots)
    return roots, para


def _samples(para, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, para.totalLoopNum, batch)),
            rng.random((para.totalTauNum, batch)) * BETA)


def assert_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12 * np.abs(ref).max())


@pytest.fixture(scope="module")
def order3():
    return _vertex4(3)


@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
def test_compile_evaluator_order3_matches_jax(order3, sum_mode):
    roots, para = order3
    varK, varT = _samples(para, 16, 7)
    kw = dict(max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
              sum_mode=sum_mode)
    expected = np.asarray(jax_compile.compile_evaluator(
        roots, dtype=np.float64, layout="flat", **kw)(varK, varT))
    compiled = port.compile_evaluator(roots, device="cpu", dtype=torch.float64, **kw)
    got = compiled(varK, varT)
    assert got.shape == expected.shape and got.dtype == torch.float64
    assert_close(got.numpy(), expected)
    assert compiled.lowered.num_slots == jax_compile.compile_evaluator(
        roots, dtype=np.float64, **kw).lowered.num_slots


@pytest.mark.parametrize("sum_mode", ["csr", "bucketed", "fused"])
def test_jax_artifact_evaluates_in_port(tmp_path, sum_mode):
    """Carrying state across: a .npz from the JAX package's export_artifact
    loads into the port and evaluates to the JAX values."""
    roots, para = _sigma2()
    path = str(tmp_path / f"sigma2_{sum_mode}.npz")
    jax_compile.export_artifact(path, roots, max_loop_num=para.totalLoopNum,
                                sum_mode=sum_mode)
    varK, varT = _samples(para, 8, 3)
    lowered_j, tables_j = jax_compile.load_artifact(path)
    expected = np.asarray(jax_make_evaluator(lowered_j, layout="flat")(
        jax_leaf(tables_j, beta=BETA, kF=KF, lam=LAM)(varK, varT)))

    lowered, tables = port.load_artifact(path)
    assert lowered.leaf_uid_to_slot == lowered_j.leaf_uid_to_slot
    kw = dict(device="cpu", dtype=torch.float64)
    leaf_fn = make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM, **kw)
    got = make_evaluator(lowered, **kw)(leaf_fn(varK, varT)).numpy()
    assert_close(got, expected)


def test_port_artifact_loads_in_jax(tmp_path):
    roots, para = _sigma2()
    path = str(tmp_path / "sigma2_port.npz")
    port.export_artifact(path, roots, max_loop_num=para.totalLoopNum, cse=True)
    lowered_j, tables_j = jax_compile.load_artifact(path)
    lowered, tables = port.load_artifact(path)
    varK, varT = _samples(para, 8, 4)
    expected = np.asarray(jax_make_evaluator(lowered_j, layout="flat")(
        jax_leaf(tables_j, beta=BETA, kF=KF, lam=LAM)(varK, varT)))
    kw = dict(device="cpu", dtype=torch.float64)
    got = make_evaluator(lowered, **kw)(
        make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM, **kw)(varK, varT))
    assert_close(got.numpy(), expected)
    assert int(np.load(path)["version"]) == port.ARTIFACT_VERSION == 2


def test_port_runs_with_jax_blocked(tmp_path):
    """A fresh interpreter with jax blocked imports the port, generates,
    lowers and evaluates order-2 Gamma4, imports and runs the two probe
    modules on the CPU, and loads no jax module."""
    roots, para = _vertex4(2)
    varK, varT = _samples(para, 8, 11)
    expected = np.asarray(jax_compile.compile_evaluator(
        roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
        dtype=np.float64, layout="flat")(varK, varT))
    np.save(tmp_path / "varK.npy", varK)
    np.save(tmp_path / "varT.npy", varT)
    script = f"""
import sys
sys.modules["jax"] = None
import numpy as np, torch
from feynmandiagram_tpu_torch import _host as h
from feynmandiagram_tpu_torch.backends import compile_evaluator
para = h.DiagPara(type=h.Ver4Diag, innerLoopNum=2, hasTau=True, filter=(h.NoHartree,),
                  interaction=(h.Interaction(h.ChargeCharge, h.Instant),))
roots = [r["diagram"] for r in h.vertex4(para)]
h.optimize_inplace(roots, level=1)
c = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta={BETA}, kF={KF},
                      lam={LAM}, device="cpu", dtype=torch.float64)
out = c(np.load({str(tmp_path / 'varK.npy')!r}), np.load({str(tmp_path / 'varT.npy')!r}))
np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
from feynmandiagram_tpu_torch.benchmarks import probe_gather, probe_mosaic_caps
assert probe_mosaic_caps.case_acc(*probe_mosaic_caps.probe_inputs("cpu"))[0, :2].tolist() \\
    == [2432, 2436]
x = probe_gather.make_inputs("cpu", 64, 16, 64, 32, 8)
assert probe_gather.gather_scale_sum(x["w"], x["idx"], x["fac"]).shape == (8, 16)
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax" and sys.modules[m])
loaded += sorted(m for m in sys.modules if m.startswith("feynmandiagram_tpu.")
                 and m.split(".")[1] in ("models", "backends", "parallel"))
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", script], check=True, env=env, timeout=300)
    assert_close(np.load(tmp_path / "out.npy"), expected)


def test_mc_protocol_on_cpu():
    roots, para = _sigma2()
    compiled = port.compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA,
                                      kF=KF, lam=LAM, device="cpu", dtype=torch.float64)
    n_roots = len(compiled.lowered.root_slots)
    kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=64,
              n_roots=n_roots, device="cpu", dtype=torch.float64, iters=3, beta=BETA)
    sps = mc_samples_per_s(compiled.fn, reps=3, **kw)
    assert np.isfinite(sps) and sps > 0
    a, b = mc_run(compiled.fn, seed=5, **kw), mc_run(compiled.fn, seed=5, **kw)
    assert a.shape == (n_roots,) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert not torch.equal(a, mc_run(compiled.fn, seed=6, **kw))
