"""The column run (``ops.kernels.pack_column_run``), on the CPU.

A stretch of two or more consecutive thin levels of a run is one launch of
``column_run_gather_reduce_kernel``, whose blocks each carry a slice of the
batch's columns through every level of the stretch.  The card runs the
kernel; here its tables and its plain version are held:

- a level's ``ColumnRows`` hold each output row's gathers, term by term,
  each operand the row of ``w`` its bucket names, a term's first operand
  flagged and pointing at the term's factor, the first ``RUN_GATHERS`` in
  the row's record and the others in the extra arrays;
- ``pack_column_run`` lays the levels' rows end to end and copies their
  factors out of the levels' pools, and ``column_run_row`` is its row of
  the C table, the launch's shape packed into one field;
- which levels are thin follows their shape at a batch and an element size
  (``is_thin``: few bytes and no row of many gathers), and ``stretches``
  cuts runs of two or more; the GV series at total order 4 is cut so at
  four batches;
- a stretch's own bound (``chip_smoke.stretch_rows``) counts each row it
  reads as it was before the launch and each row it writes once;
- a stretch is packed once and kept with its first level's tables, and
  ``run_lanes`` leaves about ``RUN_BLOCKS`` blocks at any batch;
- ``column_run_gather_reduce_plain`` over a stretch equals the levels' own
  plain launches in order, bit for bit, in every (storage, accumulation)
  pair, plain and compensated, on order-2 Gamma4, config 4 at order 2, the
  GV series at total order 4, and buckets by hand of 1-4 operands and up to
  9 terms (rows with extra gathers).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu_torch.ops import kernels  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import level_buckets, make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.lowering import FusedBucket, LevelPlan, LoweredGraph  # noqa: E402

from test_torch_host import PORT, generate, generate_taylor, lower_with  # noqa: E402

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
# (storage, accumulation, compensated): the kernel's four pairs, and Kahan
MODES = {"f64": (F64, None, False), "f64_kahan": (F64, None, True),
         "f32": (F32, None, False), "f32_kahan": (F32, None, True),
         "f32_f64": (F32, F64, False), "bf16_f32": (BF16, F32, False),
         "bf16_f32_kahan": (BF16, F32, True)}


def _hand_buckets(seed, rows=24, levels=3):
    """A lowering by hand: ``levels`` levels of fused buckets of 1-4
    operands, 1-9 terms and 1-13 outputs each, every level reading the rows
    of the leaves and of the levels before it."""
    rng = np.random.default_rng(seed)
    plan_levels, next_row = [], rows
    for _ in range(levels):
        fused = []
        readable = next_row
        for _ in range(4):
            n_op, arity, count = int(rng.integers(1, 5)), int(rng.integers(1, 10)), \
                int(rng.integers(1, 14))
            idx = rng.integers(0, readable, (n_op, arity, count)).astype(np.int32)
            fac = rng.uniform(-1.5, 1.5, (arity, count))
            fused.append(FusedBucket(arity=arity, n_op=n_op, start=next_row, count=count,
                                     idx=idx, fac=fac))
            next_row += count
        plan_levels.append(LevelPlan(sums=None, prods=[], pows=[], fused=fused))
    return LoweredGraph(num_slots=next_row, num_leaves=rows, levels=plan_levels,
                        root_slots=np.arange(rows, next_row, dtype=np.int32),
                        leaf_uid_to_slot={i: i for i in range(rows)},
                        const_slots=np.zeros(0, np.int32), const_values=np.zeros(0),
                        num_edges=0)


def _gv_series(order):
    from feynmandiagram_tpu_torch.frontends import NoHartree
    gv = importlib.import_module(f"{PORT}.frontends.gv")
    roots, _, _, _ = gv.diagsGV_series("sigma", order, filter=(NoHartree,),
                                       spin_polar_para=0.0)
    return lower_with(PORT, roots, sum_mode="fused", cse=True)


def _lowering(name):
    if name == "gamma4_o2":
        roots, _ = generate(PORT, "vertex4", 2)
    elif name == "config4_o2":
        roots, _, _ = generate_taylor(PORT, 2)
    elif name == "gv_series_o4":
        return _gv_series(4)
    else:
        return _hand_buckets(int(name.rsplit("_", 1)[1]))
    return lower_with(PORT, roots, sum_mode="fused", cse=True)


@pytest.fixture(scope="module")
def lowered():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _lowering(name)
        return cache[name]

    return get


def _gathers(tables, i):
    """Row ``i`` of a level's ``ColumnRows``: its flagged gathers and their
    factors' positions, the record's and the extra arrays' together."""
    col = tables.column
    rec = col.rows[i]
    n = int(rec[1])
    head = min(n, kernels.RUN_GATHERS)
    idx = list(rec[4:4 + head])
    at = list(col.fac_at[i, :head])
    if n > kernels.RUN_GATHERS:
        rest = int(rec[2])
        idx += list(col.extra_idx[rest:rest + n - kernels.RUN_GATHERS])
        at += list(col.extra_fac_at[rest:rest + n - kernels.RUN_GATHERS])
    return int(rec[0]), idx, at


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_rows_hold_each_rows_gathers_in_term_order(seed):
    low = _hand_buckets(seed)
    ev = make_evaluator(low, device="cpu", dtype=F64)
    for lvl, plan in zip(ev.levels, low.levels):
        t = lvl.tables
        col = t.column
        assert col.rows.dtype == np.int32 and col.rows.shape == (t.desc[:, 1].sum(), 8)
        assert col.fac_at.shape == (len(col.rows), kernels.RUN_GATHERS)
        assert not col.rows[:, 3].any()
        # rows in the order of the row tiles: the buckets by first_tile
        want_dst = np.concatenate([np.arange(s, s + c) for s, c in
                                   t.desc[np.argsort(t.desc[:, 6])][:, :2].tolist()])
        assert col.rows[:, 0].tolist() == want_dst.tolist()
        buckets = {fb.start: fb for fb in plan.fused}
        facs = t.fac.numpy()
        i = 0
        for start, count, *_ in t.desc[np.argsort(t.desc[:, 6])].tolist():
            fb = buckets[start]
            for c in range(count):
                dst, idx, at = _gathers(t, i)
                assert dst == start + c
                want = [int(fb.idx[k, a, c]) | (1 << 31 if k == 0 else 0)
                        for a in range(fb.arity) for k in range(fb.n_op)]
                assert [int(x) & 0xffffffff for x in idx] == want
                for g, pos in enumerate(at):
                    assert facs[pos] == fb.fac[g // fb.n_op, c]
                i += 1
        assert i == len(col.rows)


def test_pack_column_run_lays_the_levels_end_to_end(lowered):
    low = lowered("hand_1")
    ev = make_evaluator(low, device="cpu", dtype=F32, acc_dtype=F64)
    tabs = [lvl.tables for lvl in ev.levels]
    run = kernels.pack_column_run(tabs)
    counts = [len(t.column.rows) for t in tabs]
    assert run.level_rows.dtype == torch.int32
    assert run.level_rows.tolist() == np.concatenate([[0], np.cumsum(counts)]).tolist()
    assert run.n_levels == len(tabs)
    assert run.rows.dtype == torch.int32 and np.array_equal(run.rows.numpy(), run.host_rows)
    assert run.row_fac.dtype == F64 and run.row_fac.shape == (sum(counts), kernels.RUN_GATHERS)
    assert run.extra_idx.dtype == torch.int32 and run.extra_fac.dtype == F64
    assert np.array_equal(run.extra_idx.numpy(), run.host_extra_idx)
    first = extra = 0
    for t in tabs:
        n = len(t.column.rows)
        rows = run.host_rows[first:first + n]
        more = t.column.rows[:, 1] > kernels.RUN_GATHERS
        assert np.array_equal(rows[~more], t.column.rows[~more])
        assert np.array_equal(rows[more, 2], t.column.rows[more, 2] + extra)
        assert torch.equal(run.row_fac[first:first + n].reshape(-1),
                           t.fac[torch.as_tensor(t.column.fac_at).reshape(-1)])
        m = len(t.column.extra_idx)
        assert np.array_equal(run.host_extra_idx[extra:extra + m], t.column.extra_idx)
        assert torch.equal(run.extra_fac[extra:extra + m],
                           t.fac[torch.as_tensor(t.column.extra_fac_at)])
        first, extra = first + n, extra + m
    # one element past the extras, so that the kernel always has an address
    assert len(run.extra_idx) == extra + 1 and len(run.extra_fac) == extra + 1
    # its row of the C table
    row = kernels.column_run_row(run, 8)
    assert len(row) == len(kernels.RUN_FIELDS)
    assert row == (run.rows.data_ptr(), run.row_fac.data_ptr(), run.level_rows.data_ptr(),
                   sum(counts), 3 | kernels.RUN_THREADS << 8, len(tabs),
                   run.extra_idx.data_ptr(), run.extra_fac.data_ptr())
    assert kernels.column_run_row(run, 32)[4] == 5 | kernels.RUN_THREADS << 8
    assert kernels.column_run_row(run, 1)[4] == 0 | kernels.RUN_THREADS << 8


def test_a_column_runs_blocks_fill_the_card_at_any_batch():
    # about RUN_BLOCKS blocks of 16-byte lanes where the rows are 16-byte
    # aligned, of one element each where they are not
    assert kernels.RUN_BLOCKS == 256
    for batch, size, lanes in ((4096, 4, 4), (8192, 4, 8), (16384, 4, 16), (65536, 4, 32),
                               (2 ** 22, 4, 32), (4097, 4, 16), (8192, 8, 16),
                               (8192, 2, 4), (5, 8, 1), (1024, 4, 1)):
        assert kernels.run_lanes(batch, size) == lanes, (batch, size)
        vec = 16 // size if batch * size % 16 == 0 else 1
        blocks = -(-batch // (lanes * vec))
        assert blocks >= min(kernels.RUN_BLOCKS, -(-batch // vec)) and \
            (lanes == 1 or blocks < 2 * kernels.RUN_BLOCKS or lanes == 32)


def test_thin_levels_and_stretches_follow_the_shape(lowered, monkeypatch):
    assert kernels.stretches([]) == []
    assert kernels.stretches([True]) == []
    assert kernels.stretches([True, True, False, True, False, True, True, True]) == \
        [(0, 2), (5, 8)]
    assert kernels.stretches([False, True, True]) == [(1, 3)]
    low = lowered("gv_series_o4")
    ev = make_evaluator(low, device="cpu", dtype=F32)
    tabs = [lvl.tables for lvl in ev.levels if lvl.tables is not None]
    assert len(tabs) == sum(1 for lvl in low.levels if level_buckets(lvl))
    for t in tabs:
        edge = kernels.THIN_BYTES // (t.rows_touched * 4)    # the least batch not thin
        short = int(t.column.rows[:, 1].max()) <= kernels.RUN_MAX_GATHERS
        assert not kernels.is_thin(t, edge + 1, 4) and kernels.is_thin(t, 1, 4) == short
        assert kernels.is_thin(t, edge, 4) == \
            (short and t.rows_touched * edge * 4 < kernels.THIN_BYTES)
        with monkeypatch.context() as m:
            m.setattr(kernels, "THIN_BYTES", 0)
            assert kernels.is_thin(t, 1, 4) is False
        with monkeypatch.context() as m:
            m.setattr(kernels, "RUN_MAX_GATHERS", 10 ** 6)
            assert kernels.is_thin(t, 1, 4) is True
    # levels 1 and 2 hold rows of 32 and 128 gathers: never thin
    assert [int(t.column.rows[:, 1].max()) for t in tabs] == [4, 32, 128] + [4] * 7
    for batch, want in ((4096, [(3, 10)]), (8192, [(3, 10)]), (2 ** 17, [(6, 10)]),
                        (2 ** 20, [])):
        thin = [kernels.is_thin(t, batch, 4) for t in tabs]
        w = torch.empty((), dtype=F32).expand(ev.num_slots, batch)
        run = kernels.plan_run(w, tabs, [f"gL{i:02d}/fb1" for i in range(len(tabs))])
        cuts = kernels.stretches(thin)
        assert cuts == want
        assert [p for p, n in zip(run.paths, run.table[:, 5]) if n] == \
            [f"gL{a:02d}-gL{b - 1:02d}/run" for a, b in cuts]
        assert run.table[:, 5].sum() == sum(b - a for a, b in cuts)
        assert len(run.paths) == len(tabs) - sum(b - a - 1 for a, b in cuts)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", ["gamma4_o2", "config4_o2", "gv_series_o4", "hand_0",
                                  "hand_1", "hand_2"])
def test_the_column_run_equals_its_levels_launched_one_by_one(lowered, case, mode):
    low = lowered(case)
    storage, acc, comp = MODES[mode]
    ev = make_evaluator(low, device="cpu", dtype=storage, acc_dtype=acc, compensated=comp)
    levels = [lvl.tables for lvl in ev.levels if lvl.tables is not None]
    assert len(levels) >= 2
    rng = np.random.default_rng(11)
    batch = 5
    w0 = torch.as_tensor(rng.uniform(0.5, 1.5, (ev.num_slots, batch))).to(storage)
    w1 = w0.clone()
    run = kernels.pack_column_run(levels)
    kernels.column_run_gather_reduce_plain(w0, run, compensated=comp, acc_dtype=acc)
    for t in levels:
        kernels.level_gather_reduce_plain(w1, t, compensated=comp, acc_dtype=acc)
    assert torch.equal(w0, w1)
    assert torch.isfinite(w1).all()


@pytest.mark.parametrize("case", ["gamma4_o2", "config4_o2", "gv_series_o4", "hand_0",
                                  "hand_1"])
def test_a_stretchs_own_bound_counts_each_row_once(lowered, case):
    # chip_smoke's bound of one column run: the rows it reads as they were
    # before the launch (not yet written by an earlier level of the
    # stretch) and the rows it writes, each once, from the levels' own
    # buckets; never more than its levels' bounds summed
    import chip_smoke
    low = lowered(case)
    ev = make_evaluator(low, device="cpu", dtype=F32)
    tabs = [lvl.tables for lvl in ev.levels if lvl.tables is not None]
    outside, written = set(), set()
    for t in tabs:
        buckets = kernels.unpack_level(t)
        outside |= {int(i) for idx, _, _ in buckets for i in idx.reshape(-1)} - written
        written |= {start + c for idx, _, start in buckets for c in range(idx.shape[2])}
    got = chip_smoke.stretch_rows(kernels.pack_column_run(tabs))
    assert [x.tolist() for x in got] == [sorted(outside), sorted(written)]
    assert len(outside) + len(written) <= sum(t.rows_touched for t in tabs)


def test_a_column_run_is_packed_once_and_lives_with_its_levels(lowered):
    # a captured graph holds the column run's addresses: its tables live as
    # long as the levels' tables, whatever plans come and go
    low = lowered("gamma4_o2")
    ev = make_evaluator(low, device="cpu", dtype=F32)
    tabs = [lvl.tables for lvl in ev.levels if lvl.tables is not None]
    paths = [f"gL{i:02d}/fb1" for i in range(len(tabs))]
    w = torch.empty((), dtype=F32).expand(ev.num_slots, 8)
    first, again = (kernels.plan_run(w, tabs, paths) for _ in range(2))
    run, = first.column_runs
    assert again.column_runs[0] is run and run.n_levels == len(tabs)
    assert tabs[0].column_runs == {tuple(id(t) for t in tabs): run}
    later, = kernels.plan_run(w, tabs[1:], paths[1:]).column_runs
    assert later is not run and tabs[1].column_runs == {tuple(id(t) for t in tabs[1:]): later}
    del first, again
    assert tabs[0].column_runs[tuple(id(t) for t in tabs)] is run
