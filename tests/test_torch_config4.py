"""Config 4, the self-energy's counterterm series, through the port against
the JAX package, in float64 on the CPU.

Each package generates Σ, differentiates it with its own
``taylorAD([2, 2])``, lowers and evaluates; the port through
``benchmarks.bench_config4.build_config4``, the reference through its
``compile_evaluator`` in the flat layout, as its own tests run it on the
CPU.  Both get the same numpy-seeded ``varK`` [3, loops, B] and ``varT``
[taus, B].  This is the first path of the port whose leaves carry
derivative orders (``g_order``, ``v_order`` 0-2) end to end, and the first
whose lowering holds ``PowerPlan``s.  Tolerance rtol 1e-12 plus
1e-12 * max|ref| per root: the leaf phase's parity bound, since the
reference's G tower (nested ``jax.grad``) and the port's closed form differ
in the last digits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends import compile as jax_compile  # noqa: E402
from feynmandiagram_tpu_torch.benchmarks import bench_config4  # noqa: E402
from feynmandiagram_tpu_torch.mc import mc_run  # noqa: E402

from test_torch_host import REF, generate_taylor  # noqa: E402

BETA, KF, LAM = bench_config4.BETA, bench_config4.KF, bench_config4.LAM
CASES = [(2, "fused", 32), (2, "bucketed", 32), (3, "fused", 32), (3, "bucketed", 32),
         (4, "fused", 8)]


def _samples(para, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, para.totalLoopNum, batch)),
            rng.random((para.totalTauNum, batch)) * BETA)


def assert_close(got, ref):
    """Per root: |got - ref| <= 1e-12 |ref| + 1e-12 max|ref of that root|."""
    assert got.shape == ref.shape and np.isfinite(ref).all()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12 * np.abs(r).max())


@pytest.fixture(scope="module")
def reference():
    """The JAX package's config-4 evaluator per (order, sum_mode), and its
    roots' order tuples."""
    cache = {}

    def get(order, sum_mode):
        if (order, sum_mode) not in cache:
            roots, para, orders = generate_taylor(REF, order)
            c = jax_compile.compile_evaluator(
                roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF, lam=LAM,
                dtype=np.float64, layout="flat", sum_mode=sum_mode)
            cache[order, sum_mode] = (c, para, orders)
        return cache[order, sum_mode]

    return get


@pytest.mark.parametrize("order,sum_mode,batch", CASES)
def test_config4_matches_jax(reference, order, sum_mode, batch):
    ref_c, para, ref_orders = reference(order, sum_mode)
    compiled, port_para, orders = bench_config4.build_config4(
        order, device="cpu", dtype=torch.float64, sum_mode=sum_mode)
    assert orders == ref_orders and len(set(orders)) == 9
    assert (port_para.totalLoopNum, port_para.totalTauNum) == (para.totalLoopNum,
                                                               para.totalTauNum)
    low, low_r = compiled.lowered, ref_c.lowered
    assert (low.num_slots, low.num_edges, len(low.levels)) == (
        low_r.num_slots, low_r.num_edges, len(low_r.levels))
    assert set(compiled.tables.g_order.tolist()) == set(compiled.tables.v_order.tolist()) \
        == {0, 1, 2}
    assert sum(len(lvl.pows) for lvl in low.levels) > 0
    varK, varT = _samples(para, batch, 100 * order + batch)
    want = np.asarray(ref_c(varK, varT))
    got = compiled(varK, varT)
    assert got.dtype == torch.float64 and got.shape == (len(orders), batch)
    assert_close(got.numpy(), want)
    # every order tuple contributes: no root is identically zero
    assert (np.abs(want).max(axis=1) > 0).all()


def test_config4_order4_lowering_counts():
    """The counts the chip run is held to: 36 roots in 9 order tuples; fused
    7,160 slots, 29,011 edges, 37 levels, every one holding buckets (108
    ``FusedBucket``s, n_op 1-2), 5 ``PowerPlan``s, no ``ProdPlan``; 253
    leaves, one of them constant."""
    compiled, _, orders = bench_config4.build_config4(device="cpu")
    low = compiled.lowered
    assert len(orders) == 36 and compiled.tables.num_leaves == 252
    assert (low.num_slots, low.num_edges, len(low.levels)) == (7160, 29011, 37)
    assert all(lvl.fused for lvl in low.levels)
    assert sum(len(lvl.fused) for lvl in low.levels) == 108
    assert {fb.n_op for lvl in low.levels for fb in lvl.fused} == {1, 2}
    assert [sum(len(getattr(lvl, k)) for lvl in low.levels)
            for k in ("pows", "prods", "sum_buckets")] == [5, 0, 0]
    assert (low.num_leaves, len(low.const_slots)) == (253, 1)


def test_mc_run_matches_jax_on_the_same_samples(reference):
    """``mc.mc_run`` of the port's order-2 config 4 (float64, CPU) equals
    the reference evaluated on the very samples mc_run draws (the same
    seeded ``torch.Generator`` calls), summed over the batch and the
    passes."""
    ref_c, para, _ = reference(2, "fused")
    compiled, _, orders = bench_config4.build_config4(2, device="cpu",
                                                      dtype=torch.float64)
    batch, iters, seed = 16, 3, 4
    kw = dict(n_loop=para.totalLoopNum, num_tau=para.totalTauNum, batch=batch,
              n_roots=len(orders), device="cpu", dtype=torch.float64, iters=iters,
              beta=BETA)
    got = mc_run(compiled.fn, seed=seed, **kw)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    want = np.zeros(len(orders))
    for _ in range(iters):
        vk = torch.randn((3, para.totalLoopNum, batch), generator=gen, dtype=torch.float64)
        vt = torch.rand((para.totalTauNum, batch), generator=gen, dtype=torch.float64) * BETA
        want += np.asarray(ref_c(vk.numpy(), vt.numpy())).sum(axis=1)
    assert got.shape == (len(orders),) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_bench_config4_main_on_cpu(capsys):
    """The benchmark's entry point on the CPU, at a tiny batch: one JSON
    line with the reference's keys and order 4's counts."""
    import json
    out = bench_config4.main(["8", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    extra = out["extra"]
    assert out["metric"] == "mc_samples_per_s_config4_sigma_ct22" and out["value"] > 0
    assert set(extra) == {"host_gen_ad_s", "edges_per_s", "batch", "iters", "jit",
                          "recommended_batch", "num_roots", "num_slots", "num_edges",
                          "num_levels", "platform"}
    assert (extra["num_roots"], extra["num_slots"], extra["num_levels"]) == (36, 7160, 37)
    assert (extra["batch"], extra["iters"], extra["jit"], extra["platform"]) == (8, 1, False, "cpu")


def test_build_config4_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_config4.build_config4(2)
