"""The port's four order-scan benchmark scripts against the JAX package.

Each script's structural numbers, computed by the port from its own
generated and lowered graphs, equal the JAX package's on the same order
(2 and 3), with no tolerance: they are counts.

- ``scan_merge``: buckets and ``padded_elements`` of each default merge
  threshold against the JAX script's ``padded_elements`` on the JAX
  package's lowering (``benchmarks/scan_merge.py``, imported as it is);
  samples/s on the CPU only as a run of the loop.
- ``probe_structure``: ``structure`` against the reference script's
  statistics (``benchmarks/probe_structure.py:52-115``, restated below on
  the JAX package's lowering); for fused lowerings a fused term consumes
  each of its operands, and the JAX lowering is taken without slot reuse,
  where a slot holds one value.
- ``probe_split``: slots, leaves, edges and levels with CSE off and on
  against the JAX package's ``lower``.
- ``scaling``: on a local CPU mesh at order 2, the graph axis's roots
  against the unsharded evaluator and its per-level halo rows against the
  JAX planner's.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.backends import compile as jax_compile  # noqa: E402
from feynmandiagram_tpu.parallel import graph_shard as jax_gs  # noqa: E402
from feynmandiagram_tpu_torch.benchmarks import (probe_split, probe_structure,  # noqa: E402
                                                 scaling, scan_merge)
from feynmandiagram_tpu_torch.backends.compile import compile_evaluator  # noqa: E402

from test_torch_host import PORT, REF, generate, lower_with  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_script(name):
    """A script of the JAX package's ``benchmarks/`` directory, imported as
    it is (its JAX imports are inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vertex4():
    cache = {}

    def get(pkg, order):
        if (pkg, order) not in cache:
            cache[pkg, order] = generate(pkg, "vertex4", order)
        return cache[pkg, order]

    return get


@pytest.mark.parametrize("threshold", scan_merge.THRESHOLDS)
@pytest.mark.parametrize("order", [2, 3])
def test_scan_merge_counts_equal_the_reference_script(vertex4, order, threshold):
    ref_script = _reference_script("scan_merge")
    roots, para = vertex4(PORT, order)
    (row,) = scan_merge.scan(roots, para, [threshold], [8], device="cpu", iters=1)
    ref_roots, ref_para = vertex4(REF, order)
    low = jax_compile.compile_evaluator(
        ref_roots, max_loop_num=ref_para.totalLoopNum, beta=0.5, kF=1.919, lam=1.0,
        dtype=np.float64, sum_mode="fused", merge_threshold=threshold).lowered
    assert row["padded_elements"] == ref_script.padded_elements(low)
    assert row["buckets"] == sum(len(lv.fused) + len(lv.pows) for lv in low.levels)
    assert (row["num_slots"], row["num_edges"]) == (low.num_slots, low.num_edges)
    assert row["threshold"] == threshold and row["batch"] == 8 and row["samples_per_s"] > 0


def _reference_structure(low):
    """``benchmarks/probe_structure.py``'s statistics of ``low``, in its
    own steps, with fused buckets read as the sum buckets are (each operand
    of a nonzero term is consumed)."""
    consumers = np.zeros(low.num_slots, np.int64)
    slot_level = np.zeros(low.num_slots, np.int32)

    def reads(lvl):
        out = [b.idx[b.fac != 0] for b in lvl.sum_buckets]
        out += [b.idx[:, b.fac != 0].ravel() for b in lvl.fused]
        out += [p.idx.ravel() for p in lvl.prods] + [pw.src for pw in lvl.pows]
        return out

    def writes(lvl):
        return [(p.start, p.count) for p in
                list(lvl.sum_buckets) + list(lvl.fused) + list(lvl.prods) + list(lvl.pows)]

    for i, lvl in enumerate(low.levels, start=1):
        for read in reads(lvl):
            np.add.at(consumers, read, 1)
        for start, count in writes(lvl):
            slot_level[start:start + count] = i
    deltas = np.concatenate([i - slot_level[read] for i, lvl in enumerate(low.levels, start=1)
                             for read in reads(lvl)])
    last_use = np.zeros(low.num_slots, np.int32)
    for i, lvl in enumerate(low.levels, start=1):
        for read in reads(lvl):
            np.maximum.at(last_use, read, i)
    max_live = max(int(((slot_level <= i) & (last_use >= i)).sum())
                   for i in range(1, len(low.levels) + 1))
    prod_slots = {p.start + k for lvl in low.levels for p in lvl.prods for k in range(p.count)}
    return {"fanout_hist": np.bincount(np.minimum(consumers, 10)).tolist(),
            "distance_hist": np.bincount(np.minimum(deltas, 8)).tolist(),
            "max_live_values": max_live, "prod_nodes": len(prod_slots),
            "fanout1_prods": sum(1 for s in prod_slots if consumers[s] == 1),
            "device_ops": sum(len(lv.sum_buckets) + len(lv.fused) + len(lv.prods)
                              + len(lv.pows) for lv in low.levels),
            "per_level": [(len(lv.sum_buckets), sum(b.count for b in lv.sum_buckets),
                           sum(int((b.fac != 0).sum()) for b in lv.sum_buckets),
                           len(lv.prods), sum(p.count for p in lv.prods),
                           len(lv.pows), sum(p.count for p in lv.pows)) for lv in low.levels]}


@pytest.mark.parametrize("sum_mode", ["bucketed", "fused"])
@pytest.mark.parametrize("order", [2, 3])
def test_probe_structure_equals_the_reference_statistics(vertex4, order, sum_mode):
    roots, _ = vertex4(PORT, order)
    low = lower_with(PORT, roots, sum_mode=sum_mode, cse=True)
    got = probe_structure.structure(low)
    # without slot reuse each JAX slot holds one value
    ref_kw = {"reuse_slots": False} if sum_mode == "fused" else {}
    ref_low = lower_with(REF, vertex4(REF, order)[0], sum_mode=sum_mode, cse=True, **ref_kw)
    want = _reference_structure(ref_low)
    got_levels = [(lv["sum_buckets"], lv["sum_nodes"], lv["sum_edges"], lv["prods"],
                   lv["prod_nodes"], lv["pows"], lv["pow_nodes"]) for lv in got["per_level"]]
    assert got_levels == want.pop("per_level")
    assert {k: got[k] for k in want} == want
    assert (got["levels"], got["edges"], got["roots"]) == (
        len(ref_low.levels), ref_low.num_edges, len(ref_low.root_slots))
    assert (sum(lv["fused_edges"] for lv in got["per_level"]) > 0) == (sum_mode == "fused")
    assert "max live values" in probe_structure.report(got)


@pytest.mark.parametrize("order", [2, 3])
def test_probe_split_cse_counts_equal_the_jax_lowering(vertex4, order):
    got = probe_split.cse_counts(vertex4(PORT, order)[0])
    for cse in (False, True):
        low = lower_with(REF, vertex4(REF, order)[0], sum_mode="bucketed", cse=cse)
        assert got[cse] == {"slots": low.num_slots, "leaves": low.num_leaves,
                            "edges": low.num_edges, "levels": low.num_levels}
    assert got[True]["edges"] < got[False]["edges"]
    low = lower_with(PORT, vertex4(PORT, order)[0], sum_mode="bucketed", cse=True)
    assert probe_split.graph_traffic_bytes(low, 16) == (
        (low.num_edges + low.num_slots - low.num_leaves) * 16 * 4)


def test_scaling_graph_axis_on_a_local_cpu_mesh(vertex4):
    roots, para = vertex4(PORT, 2)
    points = scaling.graph_axis_points(roots, (1, 2, 4), 32, 1, "cpu")
    ref_low = lower_with(REF, vertex4(REF, 2)[0], sum_mode="fused", cse=True,
                         reuse_slots=False)
    for p, n in zip(points, (1, 2, 4)):
        assert p["axis"] == "graph" and p["devices"] == n
        assert p["equal_to_unsharded"] == "bit for bit" or p["equal_to_unsharded"].startswith(
            "max rel")
        stats = jax_gs._resolve_plan(ref_low, n, None, True)[1]
        assert p["halo_rows_per_level"] == list(map(int, stats.halo_rows_per_level))
        assert (p["local_slots"], p["full_slots"]) == (stats.local_slots, stats.full_slots)
        assert p["nvlink_model_ms_per_pass"] == round(
            sum(stats.halo_rows_per_level) * 4 * 32 / (scaling.NVLINK_GBPS * 1e9) * 1e3, 4)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=0.5, kF=1.919,
                                 lam=1.0, device="cpu", dtype=torch.float64)
    sample = scaling.sample_axis_points(compiled, para, (1, 2), 16, 1, "cpu")
    assert [p["devices"] for p in sample] == [1, 2] and min(p["samples_per_s"] for p in sample) > 0
    assert "| graph | 4 |" in scaling.table(sample + points)
    assert scaling.rank_counts(8) == [1, 2, 4, 8]


def test_slice_error_draws_on_an_order3_artifact(vertex4, tmp_path):
    """``slice_error`` on an order-3 artifact: each draw's four worst
    roots, inside the float32 pass's limit at this order, and seeded so that
    two calls agree."""
    from feynmandiagram_tpu_torch.backends.compile import export_artifact
    from feynmandiagram_tpu_torch.benchmarks import slice_error
    roots, para = vertex4(PORT, 3)
    path = str(tmp_path / "o3.npz")
    export_artifact(path, roots, max_loop_num=para.totalLoopNum, sum_mode="fused", cse=True)
    rows = slice_error.draws(path, 3, batch=32, n=2, device="cpu")
    assert [r["seed"] for r in rows] == [0, 1]
    for r in rows:
        for key in ("f32_pass", "f64_graph_on_f32_leaves", "f64_accumulation",
                    "f32_arithmetic_leaves"):
            err, root = r[key]
            assert 0 < err < 1e-5 and 0 <= root < 84, (key, err)
    assert rows == slice_error.draws(path, 3, batch=32, n=2, device="cpu")
