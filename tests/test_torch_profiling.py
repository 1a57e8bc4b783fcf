"""The port's profiling layer and its entry points against the JAX
package's, on the CPU.

- ``utils.lowered_cost`` equals the reference's on the order-4 Gamma4
  lowering of each package (tolerance none: the same host arithmetic on
  identical tables);
- ``utils.trace`` writes a Chrome trace that holds the hot path's scopes;
  ``utils.profiling.scope`` enters no span without a profiler;
- ``mc.mc_run`` gives the same numbers bit for bit with a profiler running
  (its scopes entered) and without, and as the scope-free loop it replaced;
- ``benchmarks.profile_pass`` at order 2 on the CPU: phases ``leaf`` and
  ``graph`` among its phases, the leaf phase's host time split by group;
- ``graft_entry``: ``entry`` builds through ``_build_compiled`` as
  ``__graft_entry__.entry`` does, the port's ``_build_compiled(2)`` equals
  the reference's on the same varK / varT in float64 (rtol 1e-12 +
  1e-12·max|ref|, the G towers differ in the last digits), and
  ``dryrun_multichip`` passes on a local CPU mesh.
"""
import glob
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_host import PORT, REF, generate, lower_with  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lowered_cost_matches_reference():
    from feynmandiagram_tpu.utils import lowered_cost as ref_cost
    from feynmandiagram_tpu_torch.utils import lowered_cost
    low_r = lower_with(REF, generate(REF, "vertex4", 4)[0], sum_mode="fused", cse=True)
    low_p = lower_with(PORT, generate(PORT, "vertex4", 4)[0], sum_mode="fused", cse=True)
    for batch in (1, 4096):
        assert lowered_cost(low_p, batch) == ref_cost(low_r, batch)
    assert lowered_cost(low_p)["num_edges"] == 46202


def _order2():
    from feynmandiagram_tpu_torch.backends.compile import compile_evaluator
    roots, para = generate(PORT, "vertex4", 2)
    return compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=0.5, kF=1.919,
                             lam=1.0, device="cpu", dtype=torch.float64), para


def test_trace_writes_the_scopes(tmp_path):
    from feynmandiagram_tpu_torch.utils import trace
    from feynmandiagram_tpu_torch.utils.profiling import scope
    compiled, para = _order2()
    rng = np.random.default_rng(1)
    varK, varT = rng.standard_normal((3, para.totalLoopNum, 8)), rng.random((5, 8)) * 0.5
    assert scope("x").__class__.__name__ == "nullcontext"
    with trace(str(tmp_path)) as prof:
        assert scope("x").__class__.__name__ != "nullcontext"
        compiled(varK, varT)
    assert prof is not None
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    levels = len(compiled.lowered.levels)
    assert {"loops", "leafG0", "leafV0", "gL00", f"gL{levels - 1:02d}"} <= names
    assert any(n.startswith("fb") for n in names)


def test_mc_run_unchanged_by_scopes():
    """mc_run with a profiler running and without, and the loop without
    scopes that it replaced, bit for bit."""
    from feynmandiagram_tpu_torch.mc import mc_run
    from feynmandiagram_tpu_torch.utils import trace
    compiled, para = _order2()
    n_roots = len(compiled.lowered.root_slots)
    kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=32, n_roots=n_roots,
              device="cpu", dtype=torch.float64, iters=3, beta=0.5, seed=5)
    plain = mc_run(compiled.fn, **kw)
    with trace(os.path.join(os.environ.get("TMPDIR", "/tmp"), "fdtpu_test_trace")):
        traced = mc_run(compiled.fn, **kw)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    acc = torch.zeros(n_roots, dtype=torch.float64)
    for _ in range(3):
        vk = torch.randn((3, para.totalLoopNum, 32), generator=gen, dtype=torch.float64)
        vt = torch.rand((para.totalTauNum, 32), generator=gen, dtype=torch.float64) * 0.5
        acc += compiled.fn(vk, vt).sum(dim=1)
    assert torch.equal(plain, traced) and torch.equal(plain, acc)


def test_profile_pass_on_cpu(capsys):
    from feynmandiagram_tpu_torch.benchmarks import profile_pass
    profile_pass.main(["2", "32", "2", "--levels", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    r = json.loads(out[-1])["profile_pass"]
    assert {"leaf", "graph", "loops", "prng", "accum"} <= set(r["phase_op"])
    assert r["phase_op"]["graph"][0] > 0 and r["phase_op"]["leaf"][1] > 0
    assert set(r["leaf_host"]) == {"leafG0", "leafV0"}
    assert sum(r["leaf_host"].values()) == pytest.approx(r["phase_host"]["leaf"])
    assert any(k.startswith("gL00/fb") for k in r["level_op"])
    assert r["card"] is None and r["device"] == "cpu" and r["levels"] > 1
    assert any(line.startswith("graph ") for line in out)


def _reference_graft_entry():
    spec = importlib.util.spec_from_file_location("_ref_graft_entry",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_graft_entry_builds_as_the_reference(monkeypatch):
    from feynmandiagram_tpu_torch import graft_entry
    ref = _reference_graft_entry()
    compiled_r, para_r = ref._build_compiled(2)
    compiled_p, para_p = graft_entry._build_compiled(2, device="cpu")
    assert para_p.totalLoopNum == para_r.totalLoopNum
    rng = np.random.default_rng(0)
    varK = rng.standard_normal((3, para_r.totalLoopNum, 64))
    varT = rng.random((para_r.totalLoopNum, 64)) * 0.5
    want = np.asarray(compiled_r.fn(varK, varT))
    got = compiled_p.fn(varK, varT)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())

    orders = []
    build = graft_entry._build_compiled

    def spy(order, **kw):
        orders.append(order)
        return build(2, **kw)       # order 4 takes ~10 s to generate here

    monkeypatch.setattr(graft_entry, "_build_compiled", spy)
    fn, (vk, vt) = graft_entry.entry(device="cpu")
    out = fn(vk, vt)
    assert orders == [4] and out.shape == (len(compiled_p.lowered.root_slots), 256)
    assert torch.isfinite(out).all()


def test_dryrun_multichip_on_a_local_mesh():
    from feynmandiagram_tpu_torch import graft_entry
    graft_entry.dryrun_multichip(4, device="cpu")
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(3, device="cpu")
