"""The port's scale-out layer against the JAX package's, on the CPU in
float64, case by case after ``tests/test_parallel.py``.

- The planner is a copy: every array of every ``_LevelSched`` and every
  field of ``ShardStats`` must equal the JAX planner's (no tolerance), each
  package planning its own lowering of its own generated graphs.
- The graph-sharded evaluator on a local mesh against the JAX package's on
  its 8-device CPU mesh, on the same numpy leaf values: rtol 1e-12 plus
  1e-12 * max|ref| per root (the config-4 tests' tolerance; the sums of the
  plain path may be taken in another order than XLA's), and against the
  port's unsharded evaluator at the same tolerance.
- The sample axis: ``shard_compiled`` and the two MC steps against the
  port's unsharded evaluator on the same draws, regenerated from the seeds
  their docstrings give (``rank_seed``).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from feynmandiagram_tpu.ops import lower as jax_lower  # noqa: E402
from feynmandiagram_tpu.parallel import graph_shard as jax_gs  # noqa: E402
from feynmandiagram_tpu.parallel import make_sample_mesh as jax_sample_mesh  # noqa: E402
from feynmandiagram_tpu_torch.backends.compile import (compile_evaluator,  # noqa: E402
                                                       leaf_graphs_of, leafmap_of)
from feynmandiagram_tpu_torch.ops import lower, make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.leaf_eval import (leaf_tables_from_lowered,  # noqa: E402
                                                    make_leaf_evaluator)
from feynmandiagram_tpu_torch.parallel import (Mesh, make_graph_sharded_evaluator,  # noqa: E402
                                               make_graph_sharded_mc_step, make_mc_step,
                                               make_sample_mesh, rank_seed, shard_compiled)
from feynmandiagram_tpu_torch.parallel import graph_shard as gs  # noqa: E402

from test_lowering import random_dag  # noqa: E402
from test_torch_host import PORT, REF, generate, to_port  # noqa: E402

BETA, KF, LAM = 0.5, 1.919, 1.0
F64 = torch.float64


def assert_close(got, ref):
    """Per root: |got - ref| <= 1e-12 |ref| + 1e-12 max|ref of that root|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(ref).all()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12 * np.abs(r).max())


def local_mesh(*axes):
    return Mesh(list(axes), device="cpu")


def _random_dag():
    """tests/test_parallel.py's random DAG (8 leaves, 4 roots, seed 21),
    built with the JAX package's classes: (JAX roots, port roots, leafmap,
    leaf values [8, 16])."""
    rng = random.Random(21)
    from feynmandiagram_tpu.computational_graph import Graph
    leaves = [Graph([], properties=("leaf", i)) for i in range(8)]
    roots = [random_dag(rng, leaves, depth=5) for _ in range(4)]
    leafmap = {leaf.id: i for i, leaf in enumerate(leaves)}
    vals = np.asarray([[rng.uniform(0.5, 1.5) for _ in range(16)] for _ in range(8)])
    return roots, to_port(roots), leafmap, vals


def _lowered_pair(kind, order, level, **kw):
    """The JAX package's and the port's lowering of the same diagrams, each
    generated, optimized and lowered by its own package."""
    roots, _ = generate(REF, kind, order, level=level)
    port_roots, _ = generate(PORT, kind, order, level=level)
    from feynmandiagram_tpu.backends.compile import leafmap_of as jax_leafmap
    return (jax_lower(roots, jax_leafmap(roots), **kw),
            lower(port_roots, leafmap_of(port_roots), **kw))


def _leaf_values(lowered, batch, seed):
    nl = lowered.num_leaves - len(lowered.const_slots)
    return np.random.default_rng(seed).uniform(0.5, 1.5, (nl, batch))


def assert_same_plan(ref_plan, port_plan):
    """Every array and field of two ``_plan`` results, with no tolerance."""
    (rl, rs, rsend, rpos, rchunk), (pl, ps, psend, ppos, pchunk) = ref_plan, port_plan
    assert rchunk == pchunk and len(rl) == len(pl)
    for name in ("n_dev", "full_slots", "local_slots", "halo_rows_per_level",
                 "read_rows_per_level", "early_rows_per_level", "interleaved"):
        assert getattr(rs, name) == getattr(ps, name), name
    assert rs.halo_bytes_per_sample() == ps.halo_bytes_per_sample()
    assert (rs.halo_pad_overhead, rs.early_share) == (ps.halo_pad_overhead, ps.early_share)
    for a, b in ((rsend, psend), (rpos, ppos)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for li, (a, b) in enumerate(zip(rl, pl)):
        for name in ("early_send", "late_send"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), (li, name)
        assert (a.early_rows, a.late_rows, a.read_rows) == (b.early_rows, b.late_rows,
                                                            b.read_rows), li
        assert len(a.groups) == len(b.groups), li
        for ga, gb in zip(a.groups, b.groups):
            assert (ga.kind, ga.chunk, ga.pow_n) == (gb.kind, gb.chunk, gb.pow_n), li
            for name in ("local_off", "idx", "fac"):
                x, y = getattr(ga, name), getattr(gb, name)
                assert x.dtype == y.dtype and x.shape == y.shape, (li, name)
                assert np.array_equal(x, y), (li, ga.kind, name)


@pytest.fixture(scope="module")
def sigma3_fused():
    return _lowered_pair("sigma", 3, 1, sum_mode="fused", cse=True, reuse_slots=False)


@pytest.fixture(scope="module")
def gamma4_order3():
    return _lowered_pair("vertex4", 3, 1, sum_mode="fused", cse=True, reuse_slots=False)


@pytest.fixture(scope="module")
def gamma4_order4():
    """Order-4 Gamma4 roots from each package, with their leafmaps."""
    from feynmandiagram_tpu.backends.compile import leafmap_of as jax_leafmap
    roots, _ = generate(REF, "vertex4", 4)
    port_roots, _ = generate(PORT, "vertex4", 4)
    return roots, jax_leafmap(roots), port_roots, leafmap_of(port_roots)


# ---------------------------------------------------------------------------
# identical plans

def test_plan_random_dag_bucketed_n8():
    roots, port_roots, leafmap, _ = _random_dag()
    kw = dict(sum_mode="bucketed", max_sum_arity=8)
    ref, port = jax_lower(roots, leafmap, **kw), lower(port_roots, leafmap, **kw)
    assert_same_plan(jax_gs._plan(ref, 8), gs._plan(port, 8))


def test_plan_sigma2_bucketed_n4():
    ref, port = _lowered_pair("sigma", 2, 0, sum_mode="bucketed")
    assert_same_plan(jax_gs._plan(ref, 4), gs._plan(port, 4))


@pytest.mark.parametrize("interleave", [False, True, None])
@pytest.mark.parametrize("local_reuse", [False, True])
def test_plan_sigma3_fused_n8(sigma3_fused, local_reuse, interleave):
    ref, port = sigma3_fused
    assert_same_plan(jax_gs._resolve_plan(ref, 8, interleave, local_reuse),
                     gs._resolve_plan(port, 8, interleave, local_reuse))


@pytest.mark.parametrize("n_dev,schedule,sizes", [
    (4, "asap", (11680, 1846, 64720, 1.092, 0.432)),
    (8, "alap", (11696, 947, 71072, 1.183, 0.382))])
def test_plan_gamma4_order4_lower_sharded_best(gamma4_order4, n_dev, schedule, sizes):
    """Order-4 Gamma4 fused at n 4 and 8: both packages' lower_sharded_best
    choose the same schedule and lowering, and plan it identically, at the
    sizes the chip run prints (full slots, slots per rank, halo bytes per
    sample in float32, padding, early share)."""
    from test_torch_host import assert_same_lowering
    roots, jax_lm, port_roots, port_lm = gamma4_order4
    ref, ref_sched = jax_gs.lower_sharded_best(roots, jax_lm, n_dev)
    port, port_sched = gs.lower_sharded_best(port_roots, port_lm, n_dev)
    assert ref_sched == port_sched == schedule
    assert_same_lowering(ref, port)
    ref_plan = jax_gs._resolve_plan(ref, n_dev, None, True)
    port_plan = gs._resolve_plan(port, n_dev, None, True)
    assert_same_plan(ref_plan, port_plan)
    st = port_plan[1]
    assert (st.full_slots, st.local_slots, st.halo_bytes_per_sample(),
            round(st.halo_pad_overhead, 3), round(st.early_share, 3)) == sizes
    assert len(port.levels) == 13


def test_lower_sharded_best_picks_min_footprint(gamma4_order3):
    """As the JAX test: the schedule with the fewest per-rank slots (halo
    rows break ties), on order-3 Gamma4 at n 8."""
    roots, _ = generate(PORT, "vertex4", 3)
    lm = leafmap_of(roots)
    stats = {}
    for sched in ("alap", "asap"):
        low = lower(roots, lm, sum_mode="fused", cse=True, reuse_slots=False, schedule=sched)
        _, st, *_ = gs._resolve_plan(low, 8, None, True)
        stats[sched] = (st.local_slots, sum(st.halo_rows_per_level))
    best_low, best_sched = gs.lower_sharded_best(roots, lm, 8)
    assert stats[best_sched] == min(stats.values())
    _, st_best, *_ = gs._resolve_plan(best_low, 8, None, True)
    assert (st_best.local_slots, sum(st_best.halo_rows_per_level)) == stats[best_sched]


# ---------------------------------------------------------------------------
# the evaluator against the JAX package's and against the unsharded one

def _jax_sharded(lowered, n, vals, **kw):
    mesh = jax_sample_mesh(n, axis_name="graph")
    return np.asarray(jax_gs.make_graph_sharded_evaluator(lowered, mesh, **kw)(vals))


def test_evaluator_random_dag_n8():
    roots, port_roots, leafmap, vals = _random_dag()
    kw = dict(sum_mode="bucketed", max_sum_arity=8)
    ref, port = jax_lower(roots, leafmap, **kw), lower(port_roots, leafmap, **kw)
    got = make_graph_sharded_evaluator(port, local_mesh(("graph", 8)))(vals)
    assert got.dtype == F64 and got.shape == (4, 16)
    assert_close(got, _jax_sharded(ref, 8, vals))
    assert_close(got, make_evaluator(port, device="cpu")(vals))


def test_evaluator_sigma2_bucketed_n4():
    ref, port = _lowered_pair("sigma", 2, 0, sum_mode="bucketed")
    vals = _leaf_values(port, 8, 9)
    got = make_graph_sharded_evaluator(port, local_mesh(("graph", 4)))(vals)
    assert_close(got, _jax_sharded(ref, 4, vals))
    assert_close(got, make_evaluator(port, device="cpu")(vals))


def test_evaluator_sigma3_fused_n8(sigma3_fused):
    ref, port = sigma3_fused
    vals = _leaf_values(port, 8, 11)
    g = make_graph_sharded_evaluator(port, local_mesh(("graph", 8)))
    got = g(vals)
    assert_close(got, _jax_sharded(ref, 8, vals))
    assert_close(got, make_evaluator(port, device="cpu")(vals))
    assert g.stats.local_slots < g.stats.full_slots // 2
    assert len(g.stats.halo_rows_per_level) == len(port.levels) + 1
    assert g.stats.halo_bytes_per_sample() > 0


def test_evaluator_2d_mesh():
    """A (graph 4 x batch 2) mesh: slot partition and sample sharding, against
    the JAX package's on its (4, 2) device mesh."""
    ref, port = _lowered_pair("sigma", 2, 0, sum_mode="fused", reuse_slots=False)
    vals = _leaf_values(port, 16, 13)
    mesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("graph", "batch"))
    expected = np.asarray(jax_gs.make_graph_sharded_evaluator(
        ref, mesh, batch_axis="batch")(vals))
    got = make_graph_sharded_evaluator(port, local_mesh(("graph", 4), ("batch", 2)),
                                       batch_axis="batch")(vals)
    assert_close(got, expected)
    assert_close(got, make_evaluator(port, device="cpu")(vals))


# ---------------------------------------------------------------------------
# options

def test_local_reuse_and_ownership_options(gamma4_order3):
    """Every (local_reuse, interleave) combination equals the unsharded
    evaluator and the JAX package's; reuse shrinks the per-rank buffer, the
    auto-pick takes the lower-traffic ownership and part of the halo is
    early, as the JAX test asserts."""
    ref, port = gamma4_order3
    roots, _ = generate(PORT, "vertex4", 3)
    live = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True,
                 reuse_slots=True).num_slots
    vals = _leaf_values(port, 8, 2)
    single = make_evaluator(port, device="cpu")(vals)
    mesh = local_mesh(("graph", 8))
    stats = {}
    for reuse in (False, True):
        for il in (False, True, None):
            g = make_graph_sharded_evaluator(port, mesh, local_reuse=reuse, interleave=il)
            got = g(vals)
            assert_close(got, single)
            assert_close(got, _jax_sharded(ref, 8, vals, local_reuse=reuse, interleave=il))
            stats[reuse, il] = g.stats
    assert stats[True, None].local_slots < live / 4
    assert stats[True, None].local_slots < stats[False, None].local_slots
    auto = sum(stats[True, None].halo_rows_per_level)
    assert auto <= min(sum(stats[True, False].halo_rows_per_level),
                       sum(stats[True, True].halo_rows_per_level))
    assert 0.1 < stats[True, None].early_share < 0.9


def test_reuse_slots_rejected():
    roots, _ = generate(PORT, "sigma", 2, level=0)
    lowered = lower(roots, leafmap_of(roots), sum_mode="fused", reuse_slots=True)
    with pytest.raises(ValueError, match="reuse_slots"):
        make_graph_sharded_evaluator(lowered, local_mesh(("graph", 4)))


def test_tile_layout_raises():
    """The TPU's tile-row layout is not ported: asking for it raises."""
    roots, _ = generate(PORT, "sigma", 2)
    lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True, reuse_slots=False)
    with pytest.raises(ValueError, match="tile"):
        make_graph_sharded_evaluator(lowered, local_mesh(("graph", 4)), layout="tile")
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), 3)
    with pytest.raises(ValueError, match="tile"):
        make_graph_sharded_mc_step(lowered, tables, local_mesh(("graph", 4), ("batch", 1)),
                                   beta=BETA, kF=KF, lam=LAM, layout="tile")


def test_mesh_collectives_and_rejects():
    mesh = local_mesh(("graph", 4), ("batch", 2))
    assert mesh.shape == {"graph": 4, "batch": 2} and mesh.size == 8
    assert list(mesh.local_ranks("graph")) == [0, 1, 2, 3] and mesh.is_local("batch")
    blocks = [torch.full((2, 3), float(r)) for r in range(4)]
    assert torch.equal(mesh.all_gather("graph", blocks), torch.cat(blocks))
    assert torch.equal(mesh.all_gather("graph", blocks, dim=1), torch.cat(blocks, dim=1))
    vals = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 5.0])]
    assert torch.equal(mesh.mean("batch", vals), (vals[0] + vals[1]) / 2)
    with pytest.raises(ValueError, match="blocks"):
        mesh.all_gather("graph", blocks[:3])
    with pytest.raises(ValueError):
        Mesh([("graph", 0)], device="cpu")
    with pytest.raises(ValueError):
        Mesh([("graph", 2), ("graph", 2)], device="cpu")
    assert make_sample_mesh(4, device="cpu").shape == {"batch": 4}
    assert make_sample_mesh(device="cpu", axis_name="graph").shape == {"graph": 1}


# ---------------------------------------------------------------------------
# the sample axis

def _sigma2_compiled():
    roots, para = generate(PORT, "sigma", 2, level=0)
    return compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                             lam=LAM, sum_mode="bucketed", device="cpu"), para


def test_shard_compiled_matches_unsharded():
    compiled, para = _sigma2_compiled()
    rng = np.random.default_rng(5)
    varK = rng.standard_normal((3, para.totalLoopNum, 64))
    varT = rng.random((para.totalTauNum, 64)) * BETA
    single = compiled(varK, varT)
    for n in (1, 8):
        got = shard_compiled(compiled, make_sample_mesh(n, device="cpu"))(varK, varT)
        assert got.shape == single.shape
        assert_close(got, single)
    with pytest.raises(ValueError, match="divide"):
        shard_compiled(compiled, make_sample_mesh(8, device="cpu"))(varK[..., :60],
                                                                   varT[:, :60])


def _draws(seed, ranks, batch, max_loop, num_tau):
    """The samples of the documented seeds: varK normal, then varT uniform."""
    gen = torch.Generator()
    gen.manual_seed(rank_seed(seed, *ranks))
    vk = torch.randn((3, max_loop, batch), generator=gen, dtype=F64)
    return vk, torch.rand((num_tau, batch), generator=gen, dtype=F64) * BETA


def test_mc_step_matches_unsharded_draws():
    compiled, para = _sigma2_compiled()
    num_tau = int(max(compiled.tables.tau_in.max(), compiled.tables.tau_out.max()))
    step = make_mc_step(compiled, make_sample_mesh(8, device="cpu"), beta=BETA)
    means = step(3, 16)
    assert means.shape == (len(compiled.lowered.root_slots),) and torch.isfinite(means).all()
    per_rank = [compiled(*_draws(3, (r,), 16, compiled.max_loop_num, num_tau)).sum(dim=1) / 16
                for r in range(8)]
    ref = per_rank[0]
    for m in per_rank[1:]:
        ref = ref + m
    assert torch.equal(means, ref / 8)
    assert not torch.equal(step(4, 16), means)


def _mc_reference(lowered, tables, seed, n_batch, bpd, iters):
    """The unsharded estimator on the draws of make_graph_sharded_mc_step."""
    leaf_fn = make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM, device="cpu")
    ev = make_evaluator(lowered, device="cpu")
    num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
    means = []
    for b in range(n_batch):
        acc = torch.zeros(len(lowered.root_slots), dtype=F64)
        for i in range(iters):
            acc = acc + ev(leaf_fn(*_draws(seed, (b, i), bpd, tables.loop_basis.shape[1],
                                           num_tau))).sum(dim=1)
        means.append(acc / (iters * bpd))
    total = means[0]
    for m in means[1:]:
        total = total + m
    return total / n_batch


def _gamma4_mc_case(order):
    roots, para = generate(PORT, "vertex4", order)
    lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True, reuse_slots=False)
    return lowered, leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), para.totalLoopNum)


def test_graph_sharded_mc_step_2d():
    """The config-5 shape on a (graph 4 x batch 2) local mesh: equal to the
    unsharded estimator on the same draws."""
    lowered, tables = _gamma4_mc_case(2)
    mesh = local_mesh(("graph", 4), ("batch", 2))
    step = make_graph_sharded_mc_step(lowered, tables, mesh, beta=BETA, kF=KF, lam=LAM)
    means = step(42, 8, 3)
    assert step.stats.local_slots < step.stats.full_slots
    assert_close(means[:, None], _mc_reference(lowered, tables, 42, 2, 8, 3)[:, None])


@pytest.mark.slow
def test_graph_sharded_mc_step_2d_order5():
    """BASELINE config 5 at order 5 (generation takes minutes)."""
    lowered, tables = _gamma4_mc_case(5)
    mesh = local_mesh(("graph", 4), ("batch", 2))
    step = make_graph_sharded_mc_step(lowered, tables, mesh, beta=BETA, kF=KF, lam=LAM)
    means = step(55, 4, 2)
    assert step.stats.local_slots < step.stats.full_slots / 4
    assert_close(means[:, None], _mc_reference(lowered, tables, 55, 2, 4, 2)[:, None])


@pytest.mark.parametrize("script", ["sigma_mc", "config5_serving", "certify_sharded"])
def test_scripts_run_on_cpu(script, tmp_path, capsys):
    """The three scripts of the layer, at small sizes on the CPU."""
    import json
    if script == "sigma_mc":
        from feynmandiagram_tpu_torch.examples import sigma_mc
        sigma_mc.main(["--batch", "256", "--device", "cpu"])
        assert "MC step means" in capsys.readouterr().out
    elif script == "config5_serving":
        from feynmandiagram_tpu_torch.examples import config5_serving
        config5_serving.main(["2", str(tmp_path / "o2.npz"), "--device", "cpu",
                              "--batch-per-device", "4", "--iters", "2"])
        out = capsys.readouterr().out
        assert "[generate] order 2" in out and "{'graph': 4, 'batch': 2}" in out
    else:
        from feynmandiagram_tpu_torch.benchmarks import certify_sharded
        certify_sharded.main(["--order", "2", "--n-graph", "4", "--device", "cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["local_slots_per_rank"] < line["full_slots"]
        assert line["order"] == 2 and line["dtype"] == "float64"
