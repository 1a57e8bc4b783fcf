"""The port's captured sharded passes (``jit=True`` on ``parallel``) on the
CPU: the bodies a CUDA graph captures, run eagerly, against the eager
sharded pass and the JAX package's jitted graph-sharded evaluator.

A CUDA graph is captured and replayed only on the card (``chip_smoke.py``'s
``jit sharded`` phase).  Here, in float64:

- ``StaticShardedPass.run`` (each rank's buffers allocated once) equals the
  eager sharded pass bit for bit (the same operations on the same values),
  also with each rank's buffer poisoned with NaN outside the rows that
  ``sharded_unwritten_reads`` zeroes, and lies within rtol 1e-12 plus
  1e-12 * max|ref| per root of the JAX package's jitted
  ``make_graph_sharded_evaluator`` on its 8-device CPU mesh (the tolerance
  of ``tests/test_torch_parallel.py``): Sigma order 2 bucketed on 4 graph
  ranks, Sigma order 3 fused on 8, Gamma4 order 3 fused on a 2 x 2 graph x
  batch mesh.
- The four entry points with ``jit=True`` run with ``tests/test_torch_jit.py``'s
  stand-in for ``capture`` (a replay runs the body eagerly) and equal their
  eager selves on the same ``rank_seed`` draws; a new batch size captures
  again, a new seed does not.
- ``jit=True`` raises ``ValueError`` on the CPU, in the entry points and in
  the four scripts' ``--jit``.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from feynmandiagram_tpu.parallel import graph_shard as jax_gs  # noqa: E402
from feynmandiagram_tpu_torch.ops import graphs  # noqa: E402
from feynmandiagram_tpu_torch.parallel import (make_graph_sharded_evaluator,  # noqa: E402
                                               make_graph_sharded_mc_step, make_mc_step,
                                               make_sample_mesh, shard_compiled)
from feynmandiagram_tpu_torch.parallel import graph_shard as gs  # noqa: E402
from feynmandiagram_tpu_torch.parallel import sharding  # noqa: E402

from test_torch_jit import _StandIn  # noqa: E402
from test_torch_parallel import (BETA, KF, LAM, _gamma4_mc_case, _jax_sharded,  # noqa: E402
                                 _leaf_values, _lowered_pair, _sigma2_compiled, assert_close,
                                 local_mesh)

CASES = {  # name: (kind, order, optimize level, lowering options, graph ranks, batch ranks)
    "sigma2 bucketed n4": ("sigma", 2, 0, dict(sum_mode="bucketed"), 4, None),
    "sigma3 fused n8": ("sigma", 3, 1, dict(sum_mode="fused", cse=True, reuse_slots=False), 8,
                        None),
    "gamma4 o3 fused 2x2": ("vertex4", 3, 1, dict(sum_mode="fused", cse=True,
                                                  reuse_slots=False), 2, 2),
}
BATCH = 16


@pytest.fixture(scope="module")
def lowerings():
    cache = {}

    def get(name):
        if name not in cache:
            kind, order, level, kw, _, _ = CASES[name]
            cache[name] = _lowered_pair(kind, order, level, **kw)
        return cache[name]

    return get


def _mesh(name):
    n_graph, n_batch = CASES[name][4:]
    return (local_mesh(("graph", n_graph)) if n_batch is None
            else local_mesh(("graph", n_graph), ("batch", n_batch)))


def _jax_reference(name, ref_low, vals):
    n_graph, n_batch = CASES[name][4:]
    if n_batch is None:
        return _jax_sharded(ref_low, n_graph, vals)
    mesh = JaxMesh(np.asarray(jax.devices()[:n_graph * n_batch]).reshape(n_graph, n_batch),
                   ("graph", "batch"))
    return np.asarray(jax_gs.make_graph_sharded_evaluator(ref_low, mesh,
                                                          batch_axis="batch")(vals))


def _static_run(sharded, mesh, vals, poison):
    """``sharded.static_pass`` on ``vals``, each batch rank's columns
    through one ``StaticShardedPass`` in turn, as a captured call runs them;
    ``poison``: every row of each rank's buffer NaN except those
    ``sharded_unwritten_reads`` zeroes."""
    vals = torch.as_tensor(vals)
    cols = ([slice(None)] if "batch" not in mesh.shape
            else sharding._rank_columns(vals.shape[1], mesh, "batch"))
    sp = sharded.static_pass(vals.shape[1] // len(cols))
    if poison:
        _poison(sp)
    parts = []
    for c in cols:
        sp.leaves.copy_(vals[:, c])
        parts.append(sp.run())
    return torch.cat(parts, dim=1)


def _poison(sp):
    for w, zero in zip(sp.ws, sp.zero_rows):
        keep = torch.zeros(w.shape[0], dtype=torch.bool)
        keep[zero] = True
        w[~keep] = float("nan")


@pytest.mark.parametrize("name", list(CASES))
def test_static_sharded_pass_equals_eager_and_jax(lowerings, name):
    ref_low, port_low = lowerings(name)
    mesh = _mesh(name)
    batch_axis = "batch" if "batch" in mesh.shape else None
    vals = _leaf_values(port_low, BATCH, 31)
    sharded = make_graph_sharded_evaluator(port_low, mesh, batch_axis=batch_axis)
    want = sharded(vals)
    for poison in (False, True):
        got = _static_run(sharded, mesh, vals, poison)
        assert got.dtype == torch.float64 and torch.equal(got, want), (name, poison)
    assert_close(want.numpy(), _jax_reference(name, ref_low, vals))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_unwritten_reads_of_real_plans_are_empty(lowerings, name):
    """Padded send entries read the leaf row 0 and padded chunk rows are
    written with their group's: no row of a rank's buffer is read before it
    is written, on any rank, with either ownership layout."""
    port_low = lowerings(name)[1]
    n_graph = CASES[name][4]
    for interleave in (False, True):
        levels, stats, root_send, _, leaf_chunk = gs._plan(port_low, n_graph,
                                                          interleave=interleave)
        for d in range(n_graph):
            zero, rezero = gs.sharded_unwritten_reads(levels, root_send, leaf_chunk,
                                                      stats.local_slots, d)
            assert zero.size == 0 and rezero.size == 0, (name, interleave, d)


def test_sharded_unwritten_reads_finds_rows_read_before_written(lowerings, monkeypatch):
    """Two reads made stale on purpose: a late send of the last level that
    a group reads now reads a row that the last level writes (zeroed before
    every pass), and an entry of the root send table that a root reads, a
    row past every group's (zeroed once), for a root other than the one
    the first row holds.  The static pass, NaN elsewhere, gives the eager
    pass's roots twice in a row; NaN everywhere, it does not."""
    port_low = lowerings("sigma3 fused n8")[1]
    levels, stats, root_send, root_pos, leaf_chunk = copy.deepcopy(
        gs._plan(port_low, 8, interleave=False, local_reuse=False))   # a row, one value
    last = levels[-1]
    read = np.unique(np.concatenate([g.idx.ravel() for g in last.groups]))
    d_late, k_late = divmod(int(read[read >= last.early_rows][0]) - last.early_rows,
                            last.late_send.shape[1])
    later = int(last.groups[0].local_off[d_late])
    last.late_send[d_late, k_late] = later
    d_root, k_root = next((d, k) for d, k in (divmod(int(p), root_send.shape[1])
                                              for p in root_pos)
                          if (d, root_send[d, k]) != (d_late, later))
    stats.local_slots += 1
    never = stats.local_slots - 1
    root_send[d_root, k_root] = never
    found = {d: gs.sharded_unwritten_reads(levels, root_send, leaf_chunk, stats.local_slots, d)
             for d in range(8)}
    assert never in found[d_root][0] and later in found[d_late][1]
    assert sum(z.size + r.size for z, r in found.values()) == 2
    monkeypatch.setattr(gs, "_resolve_plan",
                        lambda *a: (levels, stats, root_send, root_pos, leaf_chunk))
    mesh = local_mesh(("graph", 8))
    sharded = make_graph_sharded_evaluator(port_low, mesh)
    vals = torch.as_tensor(_leaf_values(port_low, BATCH, 5))
    want = sharded(vals)
    sp = sharded.static_pass(BATCH)
    _poison(sp)
    for _ in range(2):          # the second pass starts from the first's buffers
        sp.leaves.copy_(vals)
        got = sp.run()
        assert torch.isfinite(got).all() and torch.equal(got, want)
    for w in sp.ws:
        w.fill_(float("nan"))
    sp.leaves.copy_(vals)
    assert not torch.isfinite(sp.run()).all()


@pytest.fixture
def stand_in(monkeypatch):
    """``tests/test_torch_jit.py``'s stand-in capture, and ``require_cuda``
    passing the CPU, in every module that captures."""
    fake = _StandIn()
    monkeypatch.setattr(graphs, "capture", fake)
    for mod in (graphs, gs, sharding):
        monkeypatch.setattr(mod, "require_cuda", lambda device, what: None)
    return fake


@pytest.mark.parametrize("name", list(CASES))
def test_captured_sharded_evaluator_equals_eager(lowerings, stand_in, name):
    port_low = lowerings(name)[1]
    mesh = _mesh(name)
    batch_axis = "batch" if "batch" in mesh.shape else None
    eager = make_graph_sharded_evaluator(port_low, mesh, batch_axis=batch_axis)
    jitted = make_graph_sharded_evaluator(port_low, mesh, batch_axis=batch_axis, jit=True)
    assert jitted.stats == eager.stats and jitted.device_eval is not None
    a, b = _leaf_values(port_low, BATCH, 1), _leaf_values(port_low, BATCH, 2)
    ra, rb = jitted(a), jitted(b)
    assert torch.equal(ra, eager(a)) and torch.equal(rb, eager(b)) and not torch.equal(ra, rb)
    assert stand_in.captures == 1
    c = _leaf_values(port_low, 2 * BATCH, 3)
    assert torch.equal(jitted(c), eager(c)) and stand_in.captures == 2
    assert torch.equal(ra, eager(a))
    with pytest.raises(ValueError, match="leaf rows"):
        jitted(a[:-1])


@pytest.mark.parametrize("mesh_axes", [(("graph", 4), ("batch", 2)), (("graph", 2), ("batch", 2))])
def test_captured_graph_sharded_mc_step_draws_what_eager_draws(stand_in, mesh_axes):
    lowered, tables = _gamma4_mc_case(2)
    mesh = local_mesh(*mesh_axes)
    kw = dict(beta=BETA, kF=KF, lam=LAM)
    eager = make_graph_sharded_mc_step(lowered, tables, mesh, **kw)
    jitted = make_graph_sharded_mc_step(lowered, tables, mesh, jit=True, **kw)
    assert jitted.stats == eager.stats
    got = jitted(42, 8, 3)
    assert got.dtype == torch.float64 and torch.equal(got, eager(42, 8, 3))
    assert torch.equal(jitted(43, 8, 2), eager(43, 8, 2)) and stand_in.captures == 1
    assert torch.equal(jitted(42, 4, 3), eager(42, 4, 3)) and stand_in.captures == 2
    assert torch.equal(jitted(42, 8, 3), got) and stand_in.captures == 3


def test_captured_sample_axis_equals_eager(stand_in):
    compiled, para = _sigma2_compiled()
    mesh = make_sample_mesh(4, device="cpu")
    rng = np.random.default_rng(8)
    varK = rng.standard_normal((3, para.totalLoopNum, 32))
    varT = rng.random((para.totalTauNum, 32)) * BETA
    fj = shard_compiled(compiled, mesh, jit=True)
    want = shard_compiled(compiled, mesh)(varK, varT)
    assert torch.equal(fj(varK, varT), want) and stand_in.captures == 1
    assert torch.equal(fj(varK, varT), want) and stand_in.captures == 1
    with pytest.raises(ValueError, match="divide"):
        fj(varK[..., :30], varT[:, :30])
    step, sj = make_mc_step(compiled, mesh, beta=BETA), make_mc_step(compiled, mesh, beta=BETA,
                                                                      jit=True)
    for seed, bpd in ((3, 16), (4, 16), (3, 8)):
        assert torch.equal(sj(seed, bpd), step(seed, bpd))
    assert stand_in.captures == 1 + 2


def test_jit_raises_without_cuda(lowerings):
    port_low = lowerings("sigma2 bucketed n4")[1]
    lowered, tables = _gamma4_mc_case(2)
    compiled, _ = _sigma2_compiled()
    with pytest.raises(ValueError, match="CUDA"):
        make_graph_sharded_evaluator(port_low, local_mesh(("graph", 4)), jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        make_graph_sharded_mc_step(lowered, tables, local_mesh(("graph", 2), ("batch", 2)),
                                   beta=BETA, kF=KF, lam=LAM, jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        shard_compiled(compiled, make_sample_mesh(2, device="cpu"), jit=True)
    with pytest.raises(ValueError, match="CUDA"):
        make_mc_step(compiled, make_sample_mesh(2, device="cpu"), beta=BETA, jit=True)


@pytest.mark.parametrize("script", ["sigma_mc", "config5_serving", "certify_sharded", "scaling"])
def test_script_jit_flags_raise_on_cpu(script, tmp_path):
    """Each script's ``--jit`` on the CPU raises the ``ValueError`` its
    docstring names, before any timed work."""
    if script == "sigma_mc":
        from feynmandiagram_tpu_torch.examples import sigma_mc as mod
        argv = ["--batch", "64", "--device", "cpu", "--jit"]
    elif script == "config5_serving":
        from feynmandiagram_tpu_torch.examples import config5_serving as mod
        argv = ["2", str(tmp_path / "o2.npz"), "--device", "cpu", "--batch-per-device", "4",
                "--iters", "1", "--jit"]
    elif script == "certify_sharded":
        from feynmandiagram_tpu_torch.benchmarks import certify_sharded as mod
        argv = ["--order", "2", "--n-graph", "4", "--device", "cpu", "--jit"]
    else:
        from feynmandiagram_tpu_torch.benchmarks import scaling as mod
        argv = ["--ranks", "2", "--order", "2", "--device", "cpu", "--jit"]
    with pytest.raises(ValueError, match="CUDA"):
        mod.main(argv)
