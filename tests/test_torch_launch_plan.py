"""The eager pass's launch plan (``ops.evaluator.launch_plan``), on the CPU.

On the card a pass launches each run of levels (the longest sequences of
consecutive levels that only launch) from one C call,
``kernels.levels_gather_reduce``, from a host table that ``kernels.plan_run``
prepared once for the batch size: a row a launch, each level's own launch
or, for each stretch of two or more consecutive thin levels, one column run
(``kernels.pack_column_run``).  The card runs the C loop; here the library
is a stand-in that records its calls, or that runs each row of the table
through ``level_gather_reduce_plain`` or ``column_run_gather_reduce_plain``.
Held here:

- each row of a plan, for order-4 Gamma4 and config 4 (fused) at batches
  4096, 8192, 16384 and 4097, in float32, float32/float64 and compensated,
  is what ``level_gather_reduce`` passes for that level, or a column run's
  row over a stretch: the stretches are those the levels' shapes give
  (Gamma4 at 4096 and 4097 gL00-gL01, at 16384 none, its later levels
  holding rows of up to 96 gathers; config 4 at 8192 gL00-gL07 and
  gL21-gL36), a level launch's row holds the pools,
  the tile table that ``records_for`` picks and its records, the column
  group of ``_group_cols``, and the type codes;
- the runs are cut exactly at the levels that hold a CSR sum or a plan
  outside the kernel (sum_mode 'csr', a ``ProdPlan`` and a ``PowerPlan`` of
  5 operands), and Gamma4's and config 4's fused levels are one run;
- in a capture the launcher keeps one ``Launch`` a launch: ``gLNN/fb{n}``
  a level, the list the level-by-level path keeps where no level is thin,
  and ``gLNN-gLMM/run`` a column run; outside one it counts its calls, its
  level launches, its column runs and their levels, as do the kernels'
  counters;
- the pass through the plan, with the stand-in running the rows, equals the
  level-by-level pass bit for bit (the GV series at total order 4 among the
  cases: level launches and a column run in one run), builds one plan a
  batch size and keeps the newest ``PLANS_KEPT``; a failed launch names its
  level or stretch;
- a prepared leaf launch (``leaf_eval.LeafLaunch``) checks its operands
  once, and a call passes its three addresses and the stream with the
  arguments it prepared.

``tests/test_torch_column_run.py`` holds the column run's tables and its
plain version.
"""
import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu_torch.backends import compile as compile_mod  # noqa: E402
from feynmandiagram_tpu_torch.ops import build, kernels, leaf_eval  # noqa: E402
from feynmandiagram_tpu_torch.ops import evaluator as evaluator_mod  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import (cut_runs, in_kernel,  # noqa: E402
                                                    launch_plan, level_buckets,
                                                    make_evaluator)
from feynmandiagram_tpu_torch.utils import profiling  # noqa: E402

from test_torch_host import PORT, generate, generate_taylor, lower_with  # noqa: E402
from test_torch_plans_in_levels import _synthetic  # noqa: E402

F32, F64 = torch.float32, torch.float64
BATCHES = (4096, 8192, 16384, 4097)
# (storage, accumulation, compensated) of the card's float32 passes
MODES = {"f32": (F32, None, False), "f32_f64": (F32, F64, False),
         "f32_kahan": (F32, None, True)}


def _lowering(name):
    if name == "gamma4_o4":
        roots, _ = generate(PORT, "vertex4", 4)
    elif name == "config4_o4":
        roots, _, _ = generate_taylor(PORT, 4)
    elif name == "gamma4_o2_csr":
        roots, _ = generate(PORT, "vertex4", 2)
        return lower_with(PORT, roots, sum_mode="csr", cse=True)
    elif name == "gamma4_o2":
        roots, _ = generate(PORT, "vertex4", 2)
    elif name == "synthetic":
        return _synthetic()
    elif name == "gv_series_o4":
        from test_torch_column_run import _gv_series
        return _gv_series(4)
    return lower_with(PORT, roots, sum_mode="fused", cse=True)


@pytest.fixture(scope="module")
def lowered():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _lowering(name)
        return cache[name]

    return get


def _planned(low, dtype=F64, acc_dtype=None, compensated=False):
    """A CPU evaluator cut into runs, as one on the card is."""
    ev = make_evaluator(low, device="cpu", dtype=dtype, acc_dtype=acc_dtype,
                        compensated=compensated)
    ev.steps = cut_runs(ev.levels)
    ev.device_at = torch.device("cpu")
    return ev


def _shape_of(ev, batch):
    """A tensor of a pass's buffer's shape and dtype, from one element."""
    return torch.empty((), dtype=ev.dtype).expand(ev.num_slots, batch)


def _runs(plan):
    return [step for step in plan if isinstance(step, kernels.LevelRun)]


def _thin_levels(run, batch):
    """Whether each level of ``run`` (a list of levels) is in a column run
    at ``batch``, float64."""
    cuts = kernels.stretches([kernels.is_thin(lvl.tables, batch, 8) for lvl in run])
    inside = np.zeros(len(run), bool)
    for a, b in cuts:
        inside[a:b] = True
    return inside.tolist()


# the stretches that the levels' shapes give at each batch, float32
STRETCHES = {("gamma4_o4", 4096): ["gL00-gL01"],
             ("gamma4_o4", 8192): ["gL00-gL01"],
             ("gamma4_o4", 16384): [],
             ("gamma4_o4", 4097): ["gL00-gL01"],
             ("config4_o4", 4096): ["gL00-gL36"],
             ("config4_o4", 8192): ["gL00-gL07", "gL21-gL36"],
             ("config4_o4", 16384): ["gL00-gL03", "gL24-gL36"],
             ("config4_o4", 4097): ["gL00-gL36"]}


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("case", ["gamma4_o4", "config4_o4"])
def test_plan_rows_are_what_each_level_launch_takes(lowered, case, batch):
    low = lowered(case)
    kernel_levels = [i for i, lvl in enumerate(low.levels) if level_buckets(lvl)]
    assert len(kernel_levels) == {"gamma4_o4": 13, "config4_o4": 37}[case]
    for mode, (dtype, acc, comp) in MODES.items():
        ev = _planned(low, dtype, acc, comp)
        w = _shape_of(ev, batch)
        run, = _runs(launch_plan(ev, w))
        thin = [kernels.is_thin(ev.levels[i].tables, batch, 4) for i in kernel_levels]
        cuts = kernels.stretches(thin)
        assert [f"gL{kernel_levels[a]:02d}-gL{kernel_levels[b - 1]:02d}"
                for a, b in cuts] == STRETCHES[case, batch]
        n_launches = len(kernel_levels) - sum(b - a - 1 for a, b in cuts)
        assert run.table.dtype == np.int64
        assert run.table.shape == (n_launches, len(kernels.RUN_FIELDS))
        assert run.batch == batch and run.compensated == comp
        assert run.codes == kernels.cuda_type_codes(dtype, acc or dtype, acc)
        assert len(run.column_runs) == len(cuts)
        starts = dict(cuts)
        rows, columns, k = iter(run.table.tolist()), iter(run.column_runs), 0
        for path in run.paths:
            row = next(rows)
            if k in starts:
                end = starts[k]
                col = next(columns)
                assert path == f"gL{kernel_levels[k]:02d}-gL{kernel_levels[end - 1]:02d}/run"
                assert row == list(kernels.column_run_row(col, kernels.run_lanes(batch, 4)))
                assert row[5] == col.n_levels == end - k
                k = end
                continue
            i = kernel_levels[k]
            assert path == f"gL{i:02d}/{ev.levels[i].bucket_scope}"
            t = ev.levels[i].tables
            records = t.records_for(w)
            want = [t.idx.data_ptr(), t.fac.data_ptr(), records.data_ptr(), records.shape[0],
                    kernels._group_cols(w, t.rows_touched, None), 0, 0, 0]
            assert row == want, (mode, i)
            assert row[4] == max(kernels.L2_GROUP_BYTES // (t.rows_touched * 4), 1)
            k += 1
        assert k == len(kernel_levels)


@pytest.mark.parametrize("case", ["gamma4_o4", "config4_o4", "gamma4_o2_csr", "synthetic"])
def test_runs_are_cut_at_levels_that_run_python(lowered, case):
    low = lowered(case)
    ev = make_evaluator(low, device="cpu", dtype=F64)
    steps = cut_runs(ev.levels)
    index = {id(lvl): li for li, lvl in enumerate(ev.levels)}

    def runs_python(li):
        lvl = low.levels[li]
        return lvl.sums is not None or any(not in_kernel(p) for p in
                                           list(lvl.prods) + list(lvl.pows))

    # the steps in level order: a run's levels only launch, every other
    # level runs its Python, and no two runs meet
    order = [index[id(lvl)] for step in steps
             for lvl in (step if isinstance(step, list) else [step])]
    assert order == sorted(order)
    assert sorted(order) == [li for li, lvl in enumerate(low.levels)
                             if runs_python(li) or level_buckets(lvl)]
    for a, b in zip(steps, steps[1:]):
        assert not (isinstance(a, list) and isinstance(b, list))
    for step in steps:
        for lvl in (step if isinstance(step, list) else [step]):
            assert isinstance(step, list) != runs_python(index[id(lvl)])
    runs = [step for step in steps if isinstance(step, list)]
    if case in ("gamma4_o4", "config4_o4"):
        assert len(steps) == len(runs) == 1
        assert len(runs[0]) == sum(1 for lvl in low.levels if level_buckets(lvl))
    elif case == "gamma4_o2_csr":
        assert any(not isinstance(step, list) for step in steps)
        assert sum(len(run) for run in runs) == sum(
            1 for li, lvl in enumerate(low.levels)
            if not runs_python(li) and level_buckets(lvl))
    else:   # level 0 holds the arity-5 product and the power of 5
        assert len(steps) == 2 and steps[0] is ev.levels[0]
        assert len(steps[1]) == 1 and steps[1][0] is ev.levels[1]


class _Lib:
    """The C library's stand-in: records each ``fd_levels_gather_reduce``
    call and, where ``buffers`` maps a buffer's address to it, runs each row
    of the table as ``level_gather_reduce_plain`` of the level whose pools it
    points at, or as ``column_run_gather_reduce_plain`` of the column run
    whose rows it points at (found in ``plans``, the plans of a pass);
    ``fail_at`` makes that row's launch fail with cudaError 700."""

    def __init__(self, levels=(), buffers=None, fail_at=None, plans=None):
        self.calls = []
        self.tables = {lvl.tables.idx.data_ptr(): lvl.tables for lvl in levels
                       if lvl.tables is not None}
        self.buffers = buffers if buffers is not None else {}
        self.fail_at = fail_at
        self.plans = plans if plans is not None else {}

    def _column_run(self, address):
        return next(c for plan in self.plans.values() for step in plan
                    if isinstance(step, kernels.LevelRun) for c in step.column_runs
                    if c.rows.data_ptr() == address)

    def fd_levels_gather_reduce(self, w, table, n, batch, storage, acc, compensated, stream,
                                failed):
        width = len(kernels.RUN_FIELDS)
        rows = np.ctypeslib.as_array((ctypes.c_longlong * (width * n)).from_address(table))
        rows = rows.reshape(n, width).copy()
        self.calls.append((w, rows, n, batch, storage, acc, compensated, stream))
        for i, row in enumerate(rows.tolist()):
            if i == self.fail_at:
                ctypes.c_int.from_address(failed).value = i
                return 700
            if w in self.buffers:
                kw = dict(compensated=bool(compensated),
                          acc_dtype=None if acc == storage else F64)
                if row[5]:
                    kernels.column_run_gather_reduce_plain(
                        self.buffers[w], self._column_run(row[0]), **kw)
                else:
                    kernels.level_gather_reduce_plain(self.buffers[w], self.tables[row[0]],
                                                      **kw)
        return 0


@pytest.fixture
def stand_in_lib(monkeypatch):
    def install(lib):
        monkeypatch.setattr(build, "load", lambda name, bind: lib)
        return lib

    return install


def _level_by_level(ev, w, monkeypatch):
    """ev's run of levels planned on w's shape with no level thin: a launch
    a level."""
    step, = [step for step in ev.steps if isinstance(step, list)]
    with monkeypatch.context() as m:
        m.setattr(kernels, "THIN_BYTES", 0)
        return kernels.plan_run(w, [lvl.tables for lvl in step],
                                [f"{lvl.scope}/{lvl.bucket_scope}" for lvl in step],
                                compensated=ev.compensated, acc_dtype=ev.acc_dtype)


def test_launcher_keeps_the_manifest_of_the_level_path(lowered, stand_in_lib, monkeypatch):
    low = lowered("gamma4_o2")
    ev = _planned(low)
    w = torch.zeros((ev.num_slots, 8), dtype=F64)
    # no level thin: a launch a level, the manifest of the level path
    run = _level_by_level(ev, w, monkeypatch)
    assert not run.column_runs and not run.table[:, 5].any()
    lib = stand_in_lib(_Lib())
    with profiling.capturing() as planned:
        kernels.levels_gather_reduce(w, run, 0)

    # the level-by-level path on the CPU, its plain launches counted as
    # the card counts the kernel's
    plain = kernels.level_gather_reduce_plain

    def counted(*args, **kwargs):
        plain(*args, **kwargs)
        profiling.launched(kernels.level_gather_reduce)

    monkeypatch.setattr(kernels, "level_gather_reduce_plain", counted)
    with profiling.capturing() as stepwise:
        evaluator_mod._eval_levels(ev.levels, w.clone())
    assert [(x.symbol, x.path, x.kernel, x.levels) for x in planned] == \
        [(x.symbol, x.path, x.kernel, x.levels) for x in stepwise]
    assert [x.path for x in planned] == [f"gL{i:02d}/{lvl.bucket_scope}"
                                         for i, lvl in enumerate(ev.levels)
                                         if lvl.tables is not None]
    assert planned.per_kernel == {kernels.level_gather_reduce: len(run.paths)}
    # a capture counts nothing; outside one the launcher counts its call
    assert len(lib.calls) == 1
    launcher, col = kernels.levels_gather_reduce, kernels.column_run_gather_reduce

    def tally():
        return (launcher.calls, launcher.launches, kernels.level_gather_reduce.launches,
                col.launches, col.levels)

    before = tally()
    kernels.levels_gather_reduce(w, run, 0)
    kernels.levels_gather_reduce(w, run, 0)
    n = len(run.paths)
    assert tally() == tuple(b + d for b, d in zip(before, (2, 2 * n, 2 * n, 0, 0)))
    with profiling.capturing() as nested:
        with profiling.scope("outer"):
            kernels.levels_gather_reduce(w, run, 0)
    assert [x.path for x in nested] == [f"outer/{p}" for p in run.paths]

    # at batch 8 every level is thin: the run is one column run, one
    # manifest entry over all its levels, which a replay counts
    stretch, = _runs(launch_plan(ev, w))
    n_levels = len(run.paths)
    assert stretch.paths == (f"{run.paths[0].split('/')[0]}-{run.paths[-1].split('/')[0]}/run",)
    assert stretch.table[:, 5].tolist() == [n_levels]
    with profiling.capturing() as fused:
        kernels.levels_gather_reduce(w, stretch, 0)
    assert [(x.symbol, x.path, x.kernel, x.levels) for x in fused] == \
        [("column_run_gather_reduce_kernel", stretch.paths[0], col, n_levels)]
    assert fused.per_kernel == {col: 1} and fused.levels_per_kernel == {col: n_levels}
    before = tally()
    kernels.levels_gather_reduce(w, stretch, 0)
    assert tally() == tuple(b + d for b, d in zip(before, (1, 0, 0, 1, n_levels)))
    before = tally()
    profiling.replayed(fused, 3)
    assert tally() == tuple(b + d for b, d in zip(before, (0, 0, 0, 3, 3 * n_levels)))


@pytest.mark.parametrize("case", ["gamma4_o2", "gamma4_o2_csr", "synthetic", "gv_series_o4"])
@pytest.mark.parametrize("mode", ["f64", "f64_kahan"])
def test_the_pass_from_the_plan_equals_the_level_path(lowered, stand_in_lib, monkeypatch,
                                                      case, mode):
    low = lowered(case)
    comp = mode == "f64_kahan"
    ev = _planned(low, compensated=comp)
    ref = make_evaluator(low, device="cpu", dtype=F64, compensated=comp)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(evaluator_mod, "on_device", lambda device: profiling._OFF)
    buffers = {}
    lib = stand_in_lib(_Lib(ev.levels, buffers, plans=ev._plans))
    real_buffer = ev.buffer

    def buffer(batch):
        w = real_buffer(batch)
        buffers[w.data_ptr()] = w
        return w

    monkeypatch.setattr(ev, "buffer", buffer)
    rng = np.random.default_rng(7)
    nl = ev.nl_input
    built = launch_plan.built
    for batch in (5, 9, 5):
        leaves = torch.as_tensor(rng.uniform(0.5, 1.5, (nl, batch)))
        assert torch.equal(ev(leaves), ref(leaves))
    assert launch_plan.built - built == 2 and sorted(ev._plans) == [5, 9]
    runs = [step for step in ev.steps if isinstance(step, list)]
    assert len(lib.calls) == 3 * len(runs)
    for (_, rows, n, batch, storage, acc, compensated, stream), run, step in zip(
            lib.calls, runs * 3, [s for b in (5, 9, 5) for s in _runs(ev._plans[b])]):
        assert n == len(step.paths) and stream == 1234 and compensated == int(comp)
        assert (storage, acc) == kernels.cuda_type_codes(F64, F64, None)
        assert np.array_equal(rows, step.table)
        assert rows[:, 5].sum() + (rows[:, 5] == 0).sum() == len(run)
        pools = [lvl.tables.idx.data_ptr() for lvl in run]
        assert [r[0] for r in rows.tolist() if not r[5]] == \
            [p for p, thin in zip(pools, _thin_levels(run, batch)) if not thin]
    # at these batches every level is thin: each run of two levels or more
    # is one column run
    assert any(rows[:, 5].any() for _, rows, *_ in lib.calls) == \
        any(len(run) >= 2 for run in runs)
    # one plan a batch size, the newest PLANS_KEPT
    for batch in range(10, 10 + evaluator_mod.PLANS_KEPT):
        ev(torch.ones((nl, batch), dtype=F64))
    assert len(ev._plans) == evaluator_mod.PLANS_KEPT and 5 not in ev._plans
    with pytest.raises(ValueError, match="contiguous"):
        ev.eval_levels(torch.zeros((ev.num_slots, 8), dtype=F32))


def test_a_failed_launch_names_its_level(lowered, stand_in_lib, monkeypatch):
    low = lowered("gamma4_o2")
    ev = _planned(low)
    w = torch.zeros((ev.num_slots, 8), dtype=F64)
    run = _level_by_level(ev, w, monkeypatch)
    stand_in_lib(_Lib(fail_at=2))
    calls = kernels.levels_gather_reduce.calls
    with pytest.raises(RuntimeError, match=f"at level {run.paths[2]}: cudaError 700"):
        kernels.levels_gather_reduce(w, run, 0)
    stretch, = _runs(launch_plan(ev, w))
    stand_in_lib(_Lib(fail_at=0))
    with pytest.raises(RuntimeError, match=f"at level {stretch.paths[0]}: cudaError 700"):
        kernels.levels_gather_reduce(w, stretch, 0)
    assert kernels.levels_gather_reduce.calls == calls


def test_plan_run_checks_what_each_launch_checked(lowered):
    low = lowered("gamma4_o2")
    ev = _planned(low)
    tables = [lvl.tables for lvl in ev.levels if lvl.tables is not None]
    paths = [f"gL{i:02d}" for i in range(len(tables))]
    with pytest.raises(ValueError, match="writes rows"):
        kernels.plan_run(_shape_of(ev, 8)[:ev.nl_input], tables, paths)
    with pytest.raises(ValueError, match="pairs"):
        kernels.plan_run(torch.zeros((ev.num_slots, 8), dtype=torch.bfloat16), tables, paths)
    with pytest.raises(ValueError, match="paths"):
        kernels.plan_run(_shape_of(ev, 8), tables, paths[:-1])
    with pytest.raises(ValueError, match="accumulation"):
        kernels.plan_run(torch.empty((), dtype=F32).expand(ev.num_slots, 8), tables, paths)


def test_a_prepared_leaf_launch_checks_once_and_passes_the_call_addresses(stand_in_lib,
                                                                           monkeypatch):
    roots, para = generate(PORT, "vertex4", 2)
    compiled = compile_mod.compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=0.5,
                                             kF=1.919, lam=1.0, device="cpu", dtype=F64)
    plan = compiled.leaf_fn.plan
    calls = []

    class Lib:
        @staticmethod
        def fd_leaf_eval(*args):
            calls.append(args)
            return 0

    stand_in_lib(Lib)
    monkeypatch.setattr(leaf_eval, "on_device", lambda device: profiling._OFF)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=99))
    batch = 6

    def operands():
        return (torch.zeros((3, para.totalLoopNum, batch), dtype=F64),
                torch.zeros((para.totalTauNum, batch), dtype=F64),
                torch.empty((plan.num_leaves, batch), dtype=F64))

    vk, vt, out = operands()
    launch = leaf_eval.LeafLaunch(plan, vk, vt, out)
    before = leaf_eval.leaf_eval.launches
    for vk, vt, out in (operands(), operands()):
        launch.launch(vk, vt, out)
        args = calls[-1]
        assert len(args) == 25 and args[-1] == 99
        assert (args[0], args[1], args[7]) == (vk.data_ptr(), vt.data_ptr(), out.data_ptr())
        assert args[2:7] == (plan.nz_l.data_ptr(), plan.nz_coef.data_ptr(),
                             plan.segs.data_ptr(), plan.leaves.data_ptr(),
                             plan.items.data_ptr())
        assert args[8:19] == (plan.n_items, *plan.item_max, 3, plan.n_loop,
                              para.totalTauNum, batch, plan.kF2, plan.beta, plan.lam)
    assert calls[0][8:] == calls[1][8:]
    assert leaf_eval.leaf_eval.launches == before + 2
    with pytest.raises(ValueError, match="varK"):
        leaf_eval.LeafLaunch(plan, vk[:, :, :-1].contiguous(), vt, out)
    with pytest.raises(ValueError, match="out"):
        leaf_eval.LeafLaunch(plan, vk, vt, out.to(torch.int32))
