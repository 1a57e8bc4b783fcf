"""The port's whole slice against the JAX package, in float64: each package
generates, lowers and evaluates with its own host pipeline.
``compile_evaluator`` on order-3 Gamma4, artifacts carried across packages,
a run with jax and the JAX package blocked from import, the device default,
and the Monte-Carlo protocol."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends import compile as jax_compile  # noqa: E402
from feynmandiagram_tpu.ops.evaluator import make_evaluator as jax_make_evaluator  # noqa: E402
from feynmandiagram_tpu.ops.leaf_eval import make_leaf_evaluator as jax_leaf  # noqa: E402
from feynmandiagram_tpu_torch.backends import compile as port  # noqa: E402
from feynmandiagram_tpu_torch.mc import mc_run, mc_samples_per_s  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.leaf_eval import make_leaf_evaluator  # noqa: E402

from test_torch_host import PORT, REF, generate  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vertex4(order):
    """Order-``order`` Gamma4 from each package: (JAX roots, port roots, para)."""
    roots, para = generate(REF, "vertex4", order)
    return roots, generate(PORT, "vertex4", order)[0], para


def _sigma2(pkg):
    return generate(pkg, "sigma", 2, level=0)


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
    roots, port_roots, para = order3
    varK, varT = _samples(para, 16, 7)
    kw = dict(max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
              sum_mode=sum_mode)
    expected = np.asarray(jax_compile.compile_evaluator(
        roots, dtype=np.float64, layout="flat", **kw)(varK, varT))
    compiled = port.compile_evaluator(port_roots, device="cpu", dtype=torch.float64, **kw)
    got = compiled(varK, varT)
    assert got.shape == expected.shape and got.dtype == torch.float64
    assert_close(got.numpy(), expected)
    assert compiled.lowered.num_slots == jax_compile.compile_evaluator(
        roots, dtype=np.float64, **kw).lowered.num_slots


@pytest.mark.parametrize("sum_mode", ["csr", "bucketed", "fused"])
def test_jax_artifact_evaluates_in_port(tmp_path, sum_mode):
    """Carrying state across: a .npz from the JAX package's export_artifact
    loads into the port and evaluates to the JAX values."""
    roots, para = _sigma2(REF)
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
    roots, para = _sigma2(PORT)
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
    """A fresh interpreter with jax and the JAX package blocked imports the
    port, generates, lowers and evaluates order-2 Gamma4, imports and runs
    the two probe modules on the CPU, and loads no module of either."""
    roots, _, para = _vertex4(2)
    varK, varT = _samples(para, 8, 11)
    expected = np.asarray(jax_compile.compile_evaluator(
        roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
        dtype=np.float64, layout="flat")(varK, varT))
    np.save(tmp_path / "varK.npy", varK)
    np.save(tmp_path / "varT.npy", varT)
    script = f"""
import sys
sys.modules["jax"] = None
sys.modules["feynmandiagram_tpu"] = None
import numpy as np, torch
from feynmandiagram_tpu_torch.backends import compile_evaluator
from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
from feynmandiagram_tpu_torch.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram_tpu_torch.frontends.parquet import (DiagPara, Interaction, Ver4Diag,
                                                        vertex4)
para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True, filter=(NoHartree,),
                interaction=(Interaction(ChargeCharge, Instant),))
roots = [r["diagram"] for r in vertex4(para)]
optimize_inplace(roots, level=1)
c = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta={BETA}, kF={KF},
                      lam={LAM}, device="cpu", dtype=torch.float64)
out = c(np.load({str(tmp_path / 'varK.npy')!r}), np.load({str(tmp_path / 'varT.npy')!r}))
np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
from feynmandiagram_tpu_torch.benchmarks import probe_gather, probe_mosaic_caps
assert probe_mosaic_caps.case_acc(*probe_mosaic_caps.probe_inputs("cpu"))[0, :2].tolist() \\
    == [2432, 2436]
x = probe_gather.make_inputs("cpu", 64, 16, 64, 32, 8)
assert probe_gather.gather_scale_sum(x["w"], x["idx"], x["fac"]).shape == (8, 16)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "feynmandiagram_tpu") and sys.modules[m])
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", script], check=True, env=env, timeout=300)
    assert_close(np.load(tmp_path / "out.npy"), expected)


def test_default_device_raises_without_cuda():
    """No entry point carries on on the CPU unasked: without a card,
    ``make_evaluator``, ``make_leaf_evaluator`` and ``compile_evaluator``
    with no device raise, and the same calls with ``device="cpu"`` work."""
    from feynmandiagram_tpu_torch.ops.dtypes import default_device
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    roots, para = _sigma2(PORT)
    kw = dict(max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM)
    compiled = port.compile_evaluator(roots, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_evaluator(compiled.lowered)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_leaf_evaluator(compiled.tables, beta=BETA, kF=KF, lam=LAM)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.compile_evaluator(roots, **kw)


def test_port_imports_nothing_of_the_jax_package():
    """No ``.py`` of the port, and not ``chip_smoke.py``, imports
    ``feynmandiagram_tpu`` or ``jax``; ``_host.py`` is gone."""
    pattern = re.compile(
        r"^\s*(from\s+(feynmandiagram_tpu|jax)(\.[\w.]*)?\s+import\b"
        r"|import\s+(feynmandiagram_tpu|jax)(\.[\w.]*)?(\s|,|$))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, f"{os.path.relpath(path, REPO)}: {hit.group(0).strip()}"
    assert pattern.search("from feynmandiagram_tpu.ops import lowering")
    assert pattern.search("    import jax.numpy as jnp") and pattern.search("import jax")
    assert not pattern.search("from feynmandiagram_tpu_torch.ops import lowering")
    assert not os.path.exists(os.path.join(REPO, PORT, "_host.py"))


def test_mc_protocol_on_cpu():
    roots, para = _sigma2(PORT)
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
