"""The leaf kernel's work list and the ``leaf_eval`` wrapper on the CPU, and
the eager passes that start from ``torch.empty``.

- ``work_list`` (``ops/leaf_eval.py``) on order-4 Gamma4 (920 leaf rows,
  333 basis rows, 24 pairs of times), config 4's towers, GV sigma 3, the
  Hubbard atom's tables and a table with rows of no group: every leaf row
  appears once, the rows are grouped by basis row in leaf order, a basis
  row's nonzero entries are its own, the flags say which rows need eps and
  softplus (a row of V leaves alone needs neither), and an item holds at
  most ``item_leaves`` rows, the next segment not fitting, a basis row with
  more being split, and knows
  the ranges of nonzero entries and of leaf records that its segments
  read.
- The kernel's walk of that list, written here in PyTorch (per segment its
  basis row's values, then each leaf), equals the plain version
  (``leaf_eval_plain``) bit for bit, with the default items and with items
  of 1 and 3 rows (which split basis rows), in float64 and float32
  arithmetic, on float32 and float64 samples, stored in float32, float64 and
  bfloat16: tolerance none, the same operations in the same order.
- The plain version's loop sums skip the basis entries that are exactly 0,
  as the kernel does: q2 is the sum of every term's, bit for bit.
- ``leaf_eval`` on CPU tensors (the plain version) against the JAX
  package's ``make_leaf_evaluator``: float64 within rtol 1e-12 plus 1e-12 *
  max|ref| per (type, order) group, the float32 arithmetic control within
  1e-5 (``tests/test_torch_leaf_kernel.py``'s bounds and reasons); no
  launch counted; its arguments checked.
- The eager passes (``Evaluator.__call__``, ``compile_evaluator``'s ``fn``,
  the graph-sharded evaluator and MC step, ``shard_compiled`` and
  ``make_mc_step``) with every ``torch.empty`` filled with NaN: the same
  roots bit for bit, so no row is read that the pass did not write;
  ``return_all`` shows no unwritten row.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feynmandiagram_tpu.ops import leaf_eval as jax_leaf  # noqa: E402
from feynmandiagram_tpu_torch.backends.compile import compile_evaluator, eager_pass  # noqa: E402
from feynmandiagram_tpu_torch.models.free_fermion import TAU_CUTOFF  # noqa: E402
from feynmandiagram_tpu_torch.models.yukawa import EIGHT_PI  # noqa: E402
from feynmandiagram_tpu_torch.ops import leaf_eval, make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.leaf_eval import (ITEM_LEAVES, LeafTables,  # noqa: E402
                                                    leaf_plan)
from feynmandiagram_tpu_torch.parallel import (make_graph_sharded_evaluator,  # noqa: E402
                                               make_graph_sharded_mc_step, make_mc_step,
                                               make_sample_mesh, shard_compiled)

from test_torch_host import PORT, generate  # noqa: E402
from test_torch_leaf_kernel import (BETA, CASES, FIELDS, KF, LAM,  # noqa: E402
                                    _assert_groups_close, _samples)
from test_torch_parallel import _gamma4_mc_case, _lowered_pair, local_mesh  # noqa: E402

KW = dict(beta=BETA, kF=KF, lam=LAM)


@pytest.fixture(scope="module", params=sorted(CASES))
def tables(request):
    jt, n_tau = CASES[request.param]()
    return request.param, jt, LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS}), n_tau


def _basis_flags(pt):
    """Per basis row, which leaves use it: (any G0, any G, any V)."""
    nb = pt.loop_basis.shape[0]
    g = pt.leaf_type == 1
    flags = np.zeros((nb, 3), bool)
    np.logical_or.at(flags[:, 0], pt.loop_idx[g & (pt.g_order == 0)], True)
    np.logical_or.at(flags[:, 1], pt.loop_idx[g], True)
    np.logical_or.at(flags[:, 2], pt.loop_idx[pt.leaf_type == 2], True)
    return flags


@pytest.mark.parametrize("item_leaves", [ITEM_LEAVES, 3, 1])
def test_work_list_groups_every_leaf_once_by_basis_row(tables, item_leaves):
    name, _, pt, _ = tables
    plan = leaf_plan(pt, device="cpu", item_leaves=item_leaves, **KW)
    rows, leaves = plan.rows.numpy(), plan.leaves.numpy()
    segs, items = plan.segs.numpy(), plan.items.numpy()
    nz_l, nz_coef = plan.nz_l.numpy(), plan.nz_coef.numpy()
    basis = np.asarray(pt.loop_basis, np.float64)
    assert np.array_equal(np.sort(leaves[:, 0]), np.arange(pt.num_leaves))
    assert np.array_equal(leaves[:, 1], rows[leaves[:, 0], 0] | rows[leaves[:, 0], 1] << 8)
    g = pt.leaf_type[leaves[:, 0]] == 1
    assert np.array_equal(leaves[g, 2], pt.tau_in[leaves[g, 0]] - 1)
    assert np.array_equal(leaves[g, 3], pt.tau_out[leaves[g, 0]] - 1)
    assert plan.n_tau == (int(max(pt.tau_in[pt.leaf_type == 1].max(),
                                  pt.tau_out[pt.leaf_type == 1].max()))
                          if (pt.leaf_type == 1).any() else 0)
    # segments tile the leaves in order; a basis row's segments follow one
    # another, its leaves in leaf order; the rows of no group come last
    assert segs[0, 2] == 0 and segs[-1, 3] == pt.num_leaves
    assert np.array_equal(segs[1:, 2], segs[:-1, 3])
    flags = _basis_flags(pt)
    typed = np.isin(pt.leaf_type, (1, 2))
    seen, last_leaf = [], {}
    for first_nz, meta, begin, end in segs:
        members = leaves[begin:end, 0]
        assert 1 <= len(members) <= item_leaves
        if not meta & leaf_eval.SEG_HAS_BASIS:
            assert meta == 0 and not typed[members].any()
            seen.append(None)
            continue
        assert typed[members].all()
        b = int(rows[members[0], 2])
        assert (rows[members, 2] == b).all() and members[0] > last_leaf.get(b, -1)
        assert (np.diff(members) > 0).all()
        last_leaf[b] = members[-1]
        if seen and seen[-1] != b:
            assert b not in seen and seen[-1] is not None and seen[-1] < b
        seen.append(b)
        assert bool(meta & leaf_eval.SEG_NEED_SP) == flags[b, 0]
        assert bool(meta & leaf_eval.SEG_NEED_EPS) == flags[b, 1]
        cnt = meta & leaf_eval.SEG_NZ_MASK
        assert np.array_equal(nz_l[first_nz:first_nz + cnt], np.flatnonzero(basis[b]))
        assert np.array_equal(nz_coef[first_nz:first_nz + cnt], basis[b][basis[b] != 0])
    # a basis row is split into as many segments as its leaves need
    per_row = np.bincount(pt.loop_idx[typed], minlength=basis.shape[0])
    n_seg = sum(1 for b in seen if b is not None)
    assert n_seg == sum(-(-int(n) // item_leaves) for n in per_row if n)
    # items: the segments in order, each item at most item_leaves rows,
    # and the range of nonzero entries that its segments read
    assert items[0, 0] == 0 and items[-1, 1] == len(segs)
    assert np.array_equal(items[1:, 0], items[:-1, 1]) and (items[:, 1] > items[:, 0]).all()
    n_rows = segs[items[:, 1] - 1, 3] - segs[items[:, 0], 2]
    assert (n_rows <= item_leaves).all()
    seg_rows = segs[:, 3] - segs[:, 2]
    for a, b in items[:-1, :2]:     # the next segment would not have fitted
        assert n_rows[np.flatnonzero(items[:, 0] == a)[0]] + seg_rows[b] > item_leaves
    assert np.array_equal(items[:, 4:6], np.stack([segs[items[:, 0], 2],
                                                    segs[items[:, 1] - 1, 3]], axis=1))
    assert not items[:, 6:].any()
    for a, b, lo, hi in items[:, :4]:
        part = segs[a:b][segs[a:b, 1] & leaf_eval.SEG_HAS_BASIS != 0]
        if len(part):
            assert lo == part[:, 0].min()
            assert hi == (part[:, 0] + (part[:, 1] & leaf_eval.SEG_NZ_MASK)).max()
    assert plan.item_max == (max(np.diff(items[:, :2]).max(), 1), max(n_rows.max(), 1),
                             np.diff(items[:, 2:4]).max())
    if name == "gamma4_o4":
        assert (pt.num_leaves, plan.n_basis, plan.n_pairs) == (920, 333, 24)
        v_only = flags[:, 2] & ~flags[:, 1]
        assert v_only.sum() == 152 and per_row.max() == 22
        if item_leaves < 22:
            assert n_seg > plan.n_basis     # rows split


def _walk(plan, varK, varT, dtype):
    """The kernel's walk of ``plan``'s work list in PyTorch, in its
    operations and order: per segment its basis row's q2, eps, sp (what the
    segment's flags ask for), then each leaf's value, rounded once into its
    row."""
    c = plan.compute_dtype
    vk, vt = torch.as_tensor(varK).to(c), torch.as_tensor(varT).to(c)
    out = torch.full((plan.num_leaves, vk.shape[-1]), float("nan"), dtype=dtype)
    coef, nz_l = plan.nz_coef, plan.nz_l.tolist()
    for first_nz, meta, begin, end in plan.segs.tolist():
        if meta & leaf_eval.SEG_HAS_BASIS:
            q2 = None
            for d in range(vk.shape[0]):
                acc = torch.zeros_like(vk[0, 0])
                for e in range(first_nz, first_nz + (meta & leaf_eval.SEG_NZ_MASK)):
                    acc = acc + coef[e] * vk[d, nz_l[e]]
                q2 = acc * acc if d == 0 else q2 + acc * acc
            if meta & leaf_eval.SEG_NEED_EPS:
                eps = q2 - plan.kF2
                if meta & leaf_eval.SEG_NEED_SP:
                    sp = leaf_eval._softplus(-plan.beta * eps)
        for row, kind_order, t_in, t_out in plan.leaves[begin:end].tolist():
            kind, order = kind_order & 0xFF, kind_order >> 8
            if kind in (leaf_eval.KIND_G0, leaf_eval.KIND_G_TOWER):
                tau = vt[t_out] - vt[t_in]
                tau = torch.where(tau.abs() < TAU_CUTOFF, tau.new_full((), -TAU_CUTOFF), tau)
                pos = tau > 0
                if kind == leaf_eval.KIND_G0:
                    tau1 = torch.where(pos, tau, tau + plan.beta)
                    val = torch.exp(-(eps * tau1 + sp)) * (pos.to(c) * 2 - 1)
                else:
                    val = leaf_eval._green_tower(tau, eps, order, plan.beta, plan.polys)
            elif kind in (leaf_eval.KIND_V_LAMBDA, leaf_eval.KIND_V_TAYLOR):
                inv = 1.0 / (q2 + plan.lam)
                if kind == leaf_eval.KIND_V_LAMBDA:
                    ratio, val = plan.lam * inv, EIGHT_PI * inv
                    for _ in range(order):
                        val = val * ratio
                else:
                    val = (-EIGHT_PI if order % 2 else EIGHT_PI) * inv
                    for _ in range(order):
                        val = val * inv
            else:
                val = torch.ones_like(vt[0])
            out[row] = val.to(dtype)
    return out


@pytest.mark.parametrize("item_leaves", [ITEM_LEAVES, 3, 1])
@pytest.mark.parametrize("compute", [torch.float64, torch.float32])
def test_walk_of_the_work_list_equals_plain_bit_for_bit(tables, item_leaves, compute):
    _, _, pt, n_tau = tables
    plan = leaf_plan(pt, device="cpu", compute_dtype=compute, item_leaves=item_leaves, **KW)
    varK, varT = _samples(pt, n_tau, 6, 21)
    for samples in (torch.float64, torch.float32):
        vk = torch.as_tensor(varK).to(samples)
        vt = torch.as_tensor(varT).to(samples)
        for store in (torch.float64, torch.float32, torch.bfloat16):
            want = torch.empty((pt.num_leaves, 6), dtype=store)
            leaf_eval.leaf_eval_plain(plan, vk, vt, want)
            got = _walk(plan, vk, vt, store)
            assert torch.equal(got, want), (samples, store)


@pytest.mark.parametrize("compute", [torch.float64, torch.float32])
def test_skipping_zero_basis_entries_leaves_q2_unchanged(tables, compute):
    """q2 of the plain version (sums from 0 over the nonzero entries) equals
    the sum over every entry, the first term first, bit for bit."""
    _, _, pt, n_tau = tables
    plan = leaf_plan(pt, device="cpu", compute_dtype=compute, **KW)
    varK, varT = _samples(pt, n_tau, 16, 22)
    vk = torch.as_tensor(varK).to(compute)
    scratch = torch.empty((plan.scratch_rows(), 16), dtype=compute)
    leaf_eval.leaf_prep_plain(plan, vk, torch.as_tensor(varT).to(compute), scratch)
    q2 = None
    for d in range(3):
        acc = plan.basis[:, 0, None] * vk[d, 0]
        for l in range(1, plan.n_loop):
            acc = acc + plan.basis[:, l, None] * vk[d, l]
        q2 = acc * acc if q2 is None else q2 + acc * acc
    assert torch.equal(scratch[:plan.n_basis], q2)


@pytest.mark.parametrize("convention", ["lambda_power", "taylor"])
def test_leaf_eval_on_the_cpu_matches_jax(tables, convention):
    _, jt, pt, n_tau = tables
    varK, varT = _samples(pt, n_tau, 24, 23)
    before = leaf_eval.leaf_eval.launches
    for compute, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        dtype = np.float64 if compute == torch.float64 else np.float32
        ref = np.asarray(jax_leaf.make_leaf_evaluator(
            jt, dtype=dtype, interaction_convention=convention, **KW)(varK, varT))
        plan = leaf_plan(pt, device="cpu", compute_dtype=compute,
                         interaction_convention=convention, **KW)
        out = torch.empty((pt.num_leaves, 24), dtype=compute)
        leaf_eval.leaf_eval(plan, torch.as_tensor(varK).to(compute),
                            torch.as_tensor(varT).to(compute), out)
        _assert_groups_close(pt, out.double().numpy(), ref.astype(np.float64), rtol)
    assert leaf_eval.leaf_eval.launches == before


def test_leaf_eval_checks_its_arguments():
    jt, n_tau = CASES["gamma4_o4"]()
    pt = LeafTables.from_arrays(**{n: getattr(jt, n) for n in FIELDS})
    plan = leaf_plan(pt, device="cpu", **KW)
    varK, varT = (torch.as_tensor(x) for x in _samples(pt, n_tau, 8, 24))
    out = torch.empty((pt.num_leaves, 8))
    leaf_eval.leaf_eval(plan, varK, varT, out)
    bad = [dict(varK=varK[:, :-1].contiguous()), dict(varT=varT[:plan.n_tau - 1]),
           dict(varT=varT.float()), dict(varK=varK.int(), varT=varT.int()),
           dict(out=out[:-1]), dict(out=out.int()), dict(out=torch.empty((8, pt.num_leaves)).T),
           dict(out=torch.empty((pt.num_leaves, 8), device="meta"))]
    for kw in bad:
        args = {"varK": varK, "varT": varT, "out": out, **kw}
        with pytest.raises(ValueError):
            leaf_eval.leaf_eval(plan, args["varK"], args["varT"], args["out"])
    with pytest.raises(ValueError, match="item_leaves"):
        leaf_plan(pt, device="cpu", item_leaves=0, **KW)
    with pytest.raises(ValueError):
        leaf_eval.op_rate("exp", torch.empty(4, dtype=torch.float64), 1, 4, 8)
    with pytest.raises(ValueError):
        leaf_eval.op_rate("sin", torch.empty(4, dtype=torch.float64), 1, 4, 8)


# -- the eager passes from torch.empty, with every new buffer NaN

@pytest.fixture
def poisoned(monkeypatch):
    """A context in which every floating ``torch.empty`` is filled with NaN."""
    real = torch.empty

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        if t.is_floating_point():
            t.fill_(float("nan"))
        return t

    class Poison:
        def __enter__(self):
            monkeypatch.setattr(torch, "empty", empty)

        def __exit__(self, *exc):
            monkeypatch.setattr(torch, "empty", real)

    return Poison()


def _g4_samples(para, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, para.totalLoopNum, batch)),
            rng.random((para.totalTauNum, batch)) * BETA)


@pytest.mark.parametrize("sum_mode", ["fused", "bucketed"])
@pytest.mark.parametrize("order", [2, 3])
def test_eager_passes_read_no_unwritten_row(poisoned, order, sum_mode):
    roots, para = generate(PORT, "vertex4", order)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, device="cpu",
                                 dtype=torch.float64, sum_mode=sum_mode, **KW)
    varK, varT = _g4_samples(para, 12, order)
    want = compiled(varK, varT)
    leaves = compiled.leaf_fn(varK, varT)
    ev = compiled.graph_fn
    part = leaves.clone()
    part[-3:] = 0
    want_part = ev(part)
    with poisoned:
        assert torch.equal(compiled(varK, varT), want)
        assert torch.equal(eager_pass(compiled.leaf_fn, compiled.graph_fn)(varK, varT), want)
        assert torch.equal(ev(leaves), want)
        assert torch.equal(ev(leaves[:-3]), want_part)   # the rows not given are 0
    assert torch.isfinite(want).all()


def test_return_all_shows_no_unwritten_row(poisoned):
    """A buffer with two rows that no plan writes: ``return_all`` returns
    them as 0, every other row as the pass wrote it."""
    roots, para = generate(PORT, "vertex4", 2)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, device="cpu",
                                 dtype=torch.float64, **KW)
    low = dataclasses.replace(compiled.lowered, num_slots=compiled.lowered.num_slots + 2)
    leaves = compiled.leaf_fn(*_g4_samples(para, 8, 5))
    want = make_evaluator(low, device="cpu", dtype=torch.float64, return_all=True)(leaves)
    with poisoned:
        got = make_evaluator(low, device="cpu", dtype=torch.float64, return_all=True)(leaves)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert (got[-2:] == 0).all()
    assert torch.equal(got[:compiled.lowered.num_slots],
                       make_evaluator(compiled.lowered, device="cpu", dtype=torch.float64,
                                      return_all=True)(leaves))


def test_sharded_eager_passes_read_no_unwritten_row(poisoned):
    _, low = _lowered_pair("vertex4", 3, 1, sum_mode="fused", cse=True, reuse_slots=False)
    nl = low.num_leaves - len(low.const_slots)
    vals = torch.as_tensor(np.random.default_rng(6).uniform(0.5, 1.5, (nl, 8)))
    for mesh, axis in ((local_mesh(("graph", 4)), None),
                       (local_mesh(("graph", 2), ("batch", 2)), "batch")):
        sharded = make_graph_sharded_evaluator(low, mesh, batch_axis=axis)
        want = sharded(vals)
        with poisoned:
            assert torch.equal(sharded(vals), want)
    lowered, tables = _gamma4_mc_case(2)
    step = make_graph_sharded_mc_step(lowered, tables, local_mesh(("graph", 4), ("batch", 2)),
                                      **KW)
    want = step(7, 8, 2)
    with poisoned:
        assert torch.equal(step(7, 8, 2), want)


def test_sample_sharded_eager_passes_read_no_unwritten_row(poisoned):
    roots, para = generate(PORT, "vertex4", 2)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, device="cpu",
                                 dtype=torch.float64, **KW)
    mesh = make_sample_mesh(4, device="cpu")
    varK, varT = _g4_samples(para, 16, 8)
    want_f = shard_compiled(compiled, mesh)(varK, varT)
    want_s = make_mc_step(compiled, mesh, beta=BETA)(9, 8)
    with poisoned:
        assert torch.equal(shard_compiled(compiled, mesh)(varK, varT), want_f)
        assert torch.equal(make_mc_step(compiled, mesh, beta=BETA)(9, 8), want_s)

