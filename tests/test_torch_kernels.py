"""The port's bucket gather-reduce on the CPU: its plain version against
the JAX package's Pallas kernel (interpret mode) and against numpy, and the
wrapper's checks.  The CUDA kernel itself is checked on the card by
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from feynmandiagram_tpu.ops.kernels import bucket_gather_reduce as jax_bucket  # noqa: E402
from feynmandiagram_tpu_torch.ops import build, kernels  # noqa: E402
from feynmandiagram_tpu_torch.ops.evaluator import make_evaluator  # noqa: E402
from feynmandiagram_tpu_torch.ops.kernels import (bucket_gather_reduce,  # noqa: E402
                                                  bucket_gather_reduce_plain)


def _case(rng, S, B, A, C, n_op):
    """w has S source rows plus C destination rows after them."""
    w = rng.uniform(0.5, 1.5, (S + C, B))
    idx = rng.integers(0, S, (n_op, A, C)).astype(np.int32)
    fac = rng.choice([1.0, -1.0, 0.5, -2.0], (A, C))
    return w, idx, fac


def _numpy_ref(w, idx, fac):
    return np.einsum("ac,acb->cb", fac, np.prod(w[idx], axis=0))


@pytest.mark.timeout(300)
def test_plain_matches_pallas_interpret():
    """Shapes of tests/test_pallas_kernel.py.  The Pallas kernel computes in
    float32, so the float64 port is held to float32 precision."""
    rng = np.random.default_rng(0)
    S, B, A, C = 16, 128, 2, 8
    w = rng.random((S, B)).astype(np.float32)
    idx = rng.integers(0, S, (A, C)).astype(np.int32)
    fac = rng.choice([1.0, -1.0, 0.5], (A, C)).astype(np.float32)
    expected = np.asarray(jax_bucket(jnp.asarray(w), idx, fac, interpret=True))

    wt = torch.zeros((S + C, B), dtype=torch.float64)
    wt[:S] = torch.from_numpy(w.astype(np.float64))
    bucket_gather_reduce(wt, torch.from_numpy(idx[None]),
                         torch.from_numpy(fac.astype(np.float64)), S)
    np.testing.assert_allclose(wt[S:].numpy(), expected, rtol=1e-6)
    np.testing.assert_array_equal(wt[:S].numpy(), w)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("n_op", [1, 2, 3, 4])
def test_plain_matches_numpy(n_op, compensated):
    rng = np.random.default_rng(10 + n_op)
    S, B, A, C = 24, 33, 8, 13
    w, idx, fac = _case(rng, S, B, A, C, n_op)
    wt = torch.from_numpy(w.copy())
    bucket_gather_reduce(wt, torch.from_numpy(idx), torch.from_numpy(fac), S,
                         compensated=compensated)
    np.testing.assert_allclose(wt[S:].numpy(), _numpy_ref(w, idx, fac),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(wt[:S].numpy(), w[:S])


def test_kahan_recovers_cancelled_terms():
    """In float32, (1e6 - 1e6 + 1) x 16 loses the ones without compensation
    and keeps them with it (the JAX evaluator's Kahan recurrence)."""
    A = 48
    w = np.zeros((3, 1), np.float32)
    w[0] = 1.0
    idx = np.zeros((1, A, 1), np.int32)
    fac = np.tile(np.asarray([1.0e6, -1.0e6, 1.0], np.float32), A // 3)[:, None]
    out = {}
    for comp in (False, True):
        wt = torch.from_numpy(w.copy())
        bucket_gather_reduce(wt, torch.from_numpy(idx), torch.from_numpy(fac), 2,
                             compensated=comp)
        out[comp] = float(wt[2, 0])
    assert out[True] == pytest.approx(16.0, abs=1e-3)
    assert abs(out[True] - 16.0) <= abs(out[False] - 16.0)


@pytest.mark.parametrize("chunk_rows", [1, 5, 64])
def test_chunk_rows_and_acc_dtype_keep_values(chunk_rows):
    rng = np.random.default_rng(3)
    S, B, A, C = 20, 16, 4, 11
    w, idx, fac = _case(rng, S, B, A, C, 2)
    base = torch.from_numpy(w.copy())
    bucket_gather_reduce_plain(base, torch.from_numpy(idx), torch.from_numpy(fac), S)
    chunked = torch.from_numpy(w.copy())
    bucket_gather_reduce_plain(chunked, torch.from_numpy(idx), torch.from_numpy(fac), S,
                               chunk_rows=chunk_rows)
    np.testing.assert_allclose(chunked.numpy(), base.numpy(), rtol=1e-14)
    w32 = torch.from_numpy(w.astype(np.float32))
    bucket_gather_reduce_plain(w32, torch.from_numpy(idx),
                               torch.from_numpy(fac.astype(np.float32)), S,
                               acc_dtype=torch.float64, chunk_rows=chunk_rows)
    # float32 inputs and outputs: float32 rounding of the terms' size
    ref = base[S:].numpy()
    np.testing.assert_allclose(w32[S:].numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def _good():
    w = torch.zeros((10, 4), dtype=torch.float64)
    idx = torch.zeros((2, 3, 2), dtype=torch.int32)
    fac = torch.ones((3, 2), dtype=torch.float64)
    return w, idx, fac


@pytest.mark.parametrize("bad", ["w_1d", "w_int", "w_strided", "idx_int64", "n_op_5",
                                 "fac_shape", "rows_past_end", "negative_start"])
def test_wrapper_rejects_bad_arguments(bad):
    w, idx, fac = _good()
    start = 8
    if bad == "w_1d":
        w = w.reshape(-1)
    elif bad == "w_int":
        w = w.to(torch.int64)
    elif bad == "w_strided":
        w = torch.zeros((4, 10), dtype=torch.float64).t()
    elif bad == "idx_int64":
        idx = idx.to(torch.int64)
    elif bad == "n_op_5":
        idx = torch.zeros((5, 3, 2), dtype=torch.int32)
    elif bad == "fac_shape":
        fac = torch.ones((2, 3), dtype=torch.float64)
    elif bad == "rows_past_end":
        start = 9
    elif bad == "negative_start":
        start = -1
    with pytest.raises(ValueError):
        bucket_gather_reduce(w, idx, fac, start)


def test_non_cpu_non_cuda_tensor_raises_instead_of_plain():
    """The plain version runs only because a tensor lies on the CPU: any
    other device than cpu or cuda raises, it is not computed."""
    w, idx, fac = (t.to("meta") for t in _good())
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucket_gather_reduce(w, idx, fac, 8)


def test_cpu_path_does_not_count_launches():
    w, idx, fac = _good()
    before = kernels.level_gather_reduce.launches
    bucket_gather_reduce(w, idx, fac, 8)
    assert kernels.level_gather_reduce.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """On a machine without nvcc the CUDA build raises (no fallback)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build("bucket_gather_reduce")


F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


@pytest.mark.parametrize("storage,acc", kernels.CUDA_DTYPE_PAIRS)
def test_cuda_dtype_pairs_give_type_codes(storage, acc):
    codes = kernels.cuda_type_codes(storage, acc, acc)
    assert codes == (kernels._TYPE_CODE[storage], kernels._TYPE_CODE[acc])
    if storage == acc:
        assert kernels.cuda_type_codes(storage, acc, None) == codes


@pytest.mark.parametrize("storage,fac,acc", [
    (F64, F32, F32),     # narrower accumulation than storage
    (BF16, F64, F64),    # not instantiated
    (BF16, BF16, None),  # bf16 accumulation
    (F32, F32, F64),     # fac not in the accumulation type
    (F32, F64, None),    # fac not in the storage type
    (torch.float16, torch.float16, None),
])
def test_cuda_dtype_pair_validation_rejects(storage, fac, acc):
    """The CUDA wrapper's type check, run on the CPU apart from the launch,
    and through make_evaluator, which checks the pair before any upload."""
    with pytest.raises(ValueError):
        kernels.cuda_type_codes(storage, fac, acc)
    if fac == (acc or storage):
        with pytest.raises(ValueError):
            make_evaluator(_tiny_lowered(), device="cuda", dtype=storage, acc_dtype=acc)


def _tiny_lowered():
    from feynmandiagram_tpu.computational_graph import Graph
    from feynmandiagram_tpu.ops.lowering import lower
    leaves = [Graph([], properties=i) for i in range(2)]
    return lower([Graph(leaves, subgraph_factors=[1.0, 2.0])],
                 {leaf.id: i for i, leaf in enumerate(leaves)}, sum_mode="fused")


@pytest.mark.parametrize("compensated", [False, True])
def test_plain_bf16_storage_f32_acc(compensated):
    """bf16 storage: terms widened to float32, summed there, rounded once to
    bf16, the same as rounding the float64 sum of the same bf16 inputs to
    bf16 up to one bf16 ulp (2^-7 relative at worst)."""
    rng = np.random.default_rng(21)
    S, B, A, C = 24, 16, 8, 13
    w, idx, fac = _case(rng, S, B, A, C, 2)
    wb = torch.from_numpy(w).to(BF16)
    ref = _numpy_ref(wb.double().numpy(), idx, fac)
    bucket_gather_reduce(wb, torch.from_numpy(idx), torch.from_numpy(fac).float(), S,
                         compensated=compensated, acc_dtype=F32)
    got = wb[S:].double().numpy()
    size = _numpy_ref(np.abs(wb.double().numpy()), idx, np.abs(fac))
    assert wb.dtype == BF16
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * size)


def _rounding_excess(got, exact, size, mant_bits, rtol):
    """max |got - exact| / (half a storage ulp of the value + rtol * the
    terms' size): at most 1 where got is exact rounded once to storage."""
    mag = np.maximum(np.abs(got), np.abs(exact))
    ulp = np.exp2(np.frexp(mag)[1] - 1.0 - mant_bits)
    return np.max(np.abs(got - exact) / (0.5 * ulp + rtol * size))


@pytest.mark.parametrize("storage,acc,mant_bits,rtol", [(F32, F64, 23, 1e-12),
                                                        (BF16, F32, 7, 1e-5)])
@pytest.mark.parametrize("compensated", [False, True])
def test_wider_acc_rounds_once_and_storage_acc_does_not(storage, acc, mant_bits, rtol,
                                                        compensated):
    """With a wider acc_dtype the plain version returns the exact sum of its
    inputs rounded once to storage, within half a storage ulp plus the
    accumulation's error.  Accumulating in the storage type breaks that
    bound, so the bound (chip_smoke holds the kernel to it) tells the two
    accumulation types apart."""
    rng = np.random.default_rng(23)
    S, B, A, C = 32, 64, 16, 24
    w, idx, fac = _case(rng, S, B, A, C, 3)
    ws = torch.from_numpy(w).to(storage)
    exact = _numpy_ref(ws.double().numpy(), idx, fac)
    size = _numpy_ref(np.abs(ws.double().numpy()), idx, np.abs(fac))
    excess = {}
    for a in (acc, None):
        wk = ws.clone()
        bucket_gather_reduce(wk, torch.from_numpy(idx), torch.from_numpy(fac).to(acc), S,
                             compensated=compensated, acc_dtype=a)
        excess[a] = _rounding_excess(wk[S:].double().numpy(), exact, size, mant_bits, rtol)
    assert excess[acc] <= 1.0 < excess[None]


# ---- one launch per level: the packed tables and the level wrapper

from feynmandiagram_tpu_torch.ops.kernels import (LevelTables,  # noqa: E402
                                                  level_gather_reduce,
                                                  level_gather_reduce_plain, pack_level,
                                                  unpack_level)


def _level_case(seed, S=40, n_buckets=7):
    """A level of random buckets: mixed n_op and arity, counts that are not
    multiples of the kernel's 8-row tile, destination rows after the S
    source rows.  Returns (buckets, total rows of w)."""
    rng = np.random.default_rng(seed)
    buckets, start = [], S
    for _ in range(n_buckets):
        n_op, arity = int(rng.integers(1, 5)), int(rng.choice([1, 2, 3, 7, 16, 40]))
        count = int(rng.choice([1, 5, 8, 13, 24]))
        idx = rng.integers(0, S, (n_op, arity, count)).astype(np.int32)
        fac = rng.choice([1.0, -1.0, 0.5, -2.0, 0.0], (arity, count))
        buckets.append((idx, fac, start))
        start += count + int(rng.integers(0, 3))     # gaps between destination ranges
    return buckets, start


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_packed_level_unpacks_to_its_buckets(seed):
    buckets, _ = _level_case(seed)
    tables = pack_level(buckets, "cpu", F64)
    assert isinstance(tables, LevelTables)
    assert tables.idx.dtype == torch.int32 and tables.fac.dtype == F64
    assert sorted(tables.records) == sorted(kernels.RECORD_WIDTHS)
    assert tables.desc.shape == (len(buckets), len(kernels.DESC_FIELDS))
    got = unpack_level(tables)
    assert len(got) == len(buckets)
    for (idx, fac, start), (gi, gf, gs) in zip(buckets, got):
        assert gs == start and tuple(gi.shape) == idx.shape
        np.testing.assert_array_equal(gi.numpy(), idx)
        np.testing.assert_array_equal(gf.numpy(), fac)
    assert tables.idx.numel() == sum(b[0].size for b in buckets)
    assert tables.row_end == max(s + i.shape[2] for i, _, s in buckets)
    assert tables.rows_touched == (len(np.unique(np.concatenate(
        [i.ravel() for i, _, _ in buckets]))) + sum(i.shape[2] for i, _, _ in buckets))


def _emulate(w, tables, widest, group_cols, vec):
    """What the kernel's blocks do, item by item, read from the device
    tables alone: the item order and the record, span and pool addressing of
    csrc/bucket_gather_reduce.cu, with float64 sums.  Returns the new buffer
    and how often each element of it was written."""
    rec_table = tables.records[widest].numpy()
    pool_i, pool_f = tables.idx.numpy(), tables.fac.numpy()
    batch = w.shape[1]
    piece = 32 * vec
    item_cols = kernels.ITEM_PIECES * piece
    items = -(-batch // item_cols)
    per_group = min(max(group_cols // item_cols, 1), items)
    groups = -(-items // per_group)
    out, hits = w.copy(), np.zeros(w.shape, int)
    for item in range(groups * per_group * len(rec_table)):
        group, rest = divmod(item, per_group * len(rec_table))
        rec, k_item = divmod(rest, per_group)
        dst, rows, arity, n_op, io, fo, count, span = rec_table[rec].tolist()
        col0 = (group * per_group + k_item) * item_cols + (span & 0xffff) * piece
        cols = slice(col0, min(col0 + (span >> 16) * piece, batch))
        if col0 >= batch:
            continue
        for r in range(rows):
            acc = 0.0
            for a in range(arity):
                term = pool_f[fo + a * count + r]
                for k in range(n_op):
                    term = term * w[pool_i[io + (k * arity + a) * count + r], cols]
                acc = acc + term
            out[dst + r, cols] = acc
            hits[dst + r, cols] += 1
    return out, hits


@pytest.mark.parametrize("widest", kernels.RECORD_WIDTHS)
@pytest.mark.parametrize("batch,vec,group_cols", [(300, 4, 1), (2100, 4, 2048), (77, 1, 256),
                                                  (1030, 2, 10 ** 6)])
def test_tile_records_cover_every_output_once(widest, batch, vec, group_cols):
    """Walking the device tables as the kernel does writes every output
    element of the level exactly once, nothing else, with the plain values:
    for every record width, ragged batches, one and many column groups."""
    buckets, rows = _level_case(4, S=12, n_buckets=5)
    tables = pack_level(buckets, "cpu", F64)
    w = np.random.default_rng(1).uniform(0.5, 1.5, (rows, batch))
    out, hits = _emulate(w, tables, widest, group_cols, vec)
    expected = np.zeros(w.shape, int)
    for idx, _, start in buckets:
        expected[start:start + idx.shape[2]] = 1
    np.testing.assert_array_equal(hits, expected)
    ref = torch.from_numpy(w.copy())
    level_gather_reduce_plain(ref, tables)
    # float64 sums of up to 40 terms of size <= ~50, taken in another order
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-12, atol=1e-11)
    # records: a row tile's records are as wide as its arity allows; the
    # tiles run from the longest terms to the shortest
    t = dict(zip(kernels.TILE_FIELDS, tables.records[widest].numpy().T))
    assert (t["span"] >> 16).tolist() == [kernels._record_width(a, widest)
                                          for a in t["arity"].tolist()]
    assert kernels._record_width(1, widest) == widest and kernels._record_width(40, widest) == 1
    cost = t["n_op"] * t["arity"]
    assert np.all(cost[:-1] >= cost[1:])


@pytest.mark.parametrize("batch,dtype", [(4096, F32), (250, F32), (16384, BF16), (512, F64)])
def test_record_width_leaves_enough_blocks(batch, dtype):
    """A launch takes the widest records that leave TARGET_BLOCKS blocks,
    and one-piece records where no width does."""
    buckets, rows = _level_case(4)
    tables = pack_level(buckets, "cpu", F64)
    w = torch.empty((rows, batch), dtype=dtype)
    across = kernels._items_across(w)
    assert across == -(-batch * w.element_size() // 4096)
    table = tables.records_for(w)
    widths = [k for k in kernels.RECORD_WIDTHS
              if tables.records[k].shape[0] * across >= kernels.TARGET_BLOCKS]
    assert table is tables.records[max(widths) if widths else 1]
    assert kernels._group_cols(w, 1000) == max(
        kernels.L2_GROUP_BYTES // (1000 * w.element_size()), 1)
    assert kernels._group_cols(w, 10 ** 9) == 1


@pytest.mark.parametrize("bad", ["empty", "n_op_5", "fac_shape", "no_rows", "negative_start"])
def test_pack_level_rejects(bad):
    idx, fac = np.zeros((2, 3, 4), np.int32), np.ones((3, 4))
    buckets = {"empty": [], "n_op_5": [(np.zeros((5, 3, 4), np.int32), fac, 0)],
               "fac_shape": [(idx, np.ones((4, 3)), 0)],
               "no_rows": [(np.zeros((2, 3, 0), np.int32), np.ones((3, 0)), 0)],
               "negative_start": [(idx, fac, -1)]}[bad]
    with pytest.raises(ValueError):
        pack_level(buckets, "cpu", F64)


@pytest.mark.parametrize("batch", [16, 13])          # 13: a ragged batch
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("storage,acc", [(F64, None), (F32, None), (F32, F64), (BF16, F32)])
def test_level_plain_equals_bucket_loop_bit_for_bit(storage, acc, compensated, batch):
    """The level version, which reads its buckets back from the packed
    tables, against the plain bucket version called bucket by bucket on the
    original arrays, with ``max|diff| = 0``, and through the CPU wrapper."""
    buckets, rows = _level_case(5)
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (rows, batch))).to(storage)
    fac_dtype = acc or storage
    kw = dict(compensated=compensated, acc_dtype=acc)
    ref = w.clone()
    for idx, fac, start in buckets:
        bucket_gather_reduce_plain(ref, torch.from_numpy(idx),
                                   torch.from_numpy(fac).to(fac_dtype), start, **kw)
    tables = pack_level(buckets, "cpu", fac_dtype)
    got, via_wrapper = w.clone(), w.clone()
    level_gather_reduce_plain(got, tables, **kw)
    level_gather_reduce(via_wrapper, tables, **kw)
    assert not torch.equal(ref, w)
    assert torch.equal(got, ref) and torch.equal(via_wrapper, ref)
    # rows outside every destination range are untouched
    written = np.zeros(rows, bool)
    for idx, _, start in buckets:
        written[start:start + idx.shape[2]] = True
    assert torch.equal(got[~torch.from_numpy(written)], w[~torch.from_numpy(written)])


def test_level_wrapper_on_cpu_counts_no_launch_and_other_devices_raise():
    buckets, rows = _level_case(7)
    tables = pack_level(buckets, "cpu", F64)
    before = level_gather_reduce.launches
    level_gather_reduce(torch.ones((rows, 4), dtype=F64), tables)
    assert level_gather_reduce.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        level_gather_reduce(torch.ones((rows, 4), dtype=F64, device="meta"), tables)


def test_level_order_is_free():
    """The level's buckets read no destination row of the level, so any
    order of them gives the same buffer: the premise of one launch."""
    buckets, rows = _level_case(8)
    w = torch.from_numpy(np.random.default_rng(9).uniform(0.5, 1.5, (rows, 6)))
    a, b = w.clone(), w.clone()
    level_gather_reduce_plain(a, pack_level(buckets, "cpu", F64))
    level_gather_reduce_plain(b, pack_level(buckets[::-1], "cpu", F64))
    assert torch.equal(a, b)


def _loop_reference(rows, buckets, out):
    """Each bucket's outputs written with a loop over outputs and terms, in
    float64: out[start + c] = sum_a fac[a, c] * prod_k rows[idx[k, a, c]]."""
    for idx, fac, start in buckets:
        n_op, arity, count = idx.shape
        for c in range(count):
            acc = 0.0
            for a in range(arity):
                term = rows[idx[0, a, c]] * fac[a, c]
                for k in range(1, n_op):
                    term = term * rows[idx[k, a, c]]
                acc = acc + term
            out[start + c] = acc
    return out


@pytest.mark.parametrize("batch", [16, 13])
@pytest.mark.parametrize("compensated", [False, True])
def test_level_plain_reads_src(compensated, batch):
    """With ``src`` the indices are rows of src and the outputs rows of w (a
    graph-sharded level reading its halo): against a loop over the buckets
    written here, and through the CPU wrapper bit for bit; w's other rows
    stay as they were."""
    buckets, rows = _level_case(10, S=30)
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.uniform(0.5, 1.5, (30, batch)))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (rows, batch)))
    tables = pack_level(buckets, "cpu", F64)
    assert tables.max_index == max(int(i.max()) for i, _, _ in buckets)
    got, via_wrapper = w.clone(), w.clone()
    level_gather_reduce_plain(got, tables, compensated=compensated, src=src)
    level_gather_reduce(via_wrapper, tables, compensated=compensated, src=src)
    ref = _loop_reference(src.numpy(), buckets, w.numpy().copy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=0)
    assert torch.equal(via_wrapper, got)
    # a w whose source rows hold other values gives the same outputs: the
    # level did not read w
    other = torch.zeros_like(w)
    level_gather_reduce_plain(other, tables, compensated=compensated, src=src)
    written = np.zeros(rows, bool)
    for idx, _, start in buckets:
        written[start:start + idx.shape[2]] = True
    assert torch.equal(other[torch.from_numpy(written)], got[torch.from_numpy(written)])
    assert torch.equal(got[~torch.from_numpy(written)], w[~torch.from_numpy(written)])


def test_level_src_none_reads_w_as_before():
    """``src=None`` is the level reading w itself: the same bits as passing
    a copy of w as src (no row of the level is both read and written)."""
    buckets, rows = _level_case(12)
    w = torch.from_numpy(np.random.default_rng(13).uniform(0.5, 1.5, (rows, 9)))
    tables = pack_level(buckets, "cpu", F64)
    a, b = w.clone(), w.clone()
    level_gather_reduce(a, tables)
    level_gather_reduce(b, tables, src=w.clone())
    assert torch.equal(a, b) and not torch.equal(a, w)


@pytest.mark.parametrize("bad", ["index_past_src", "row_end_past_w", "src_dtype",
                                 "src_batch", "src_1d", "negative_index"])
def test_level_wrapper_rejects_bad_src(bad):
    buckets, rows = _level_case(14, S=20)
    tables = pack_level(buckets, "cpu", F64)
    w, src = torch.ones((rows, 8), dtype=F64), torch.ones((20, 8), dtype=F64)
    if bad == "index_past_src":
        src = src[:tables.max_index]
    elif bad == "row_end_past_w":
        w = w[:tables.row_end - 1]
    elif bad == "src_dtype":
        src = src.float()
    elif bad == "src_batch":
        src = torch.ones((20, 9), dtype=F64)
    elif bad == "src_1d":
        src = src[:, 0]
    else:
        idx, fac, start = buckets[0]
        with pytest.raises(ValueError):
            pack_level([(idx - idx.max() - 1, fac, start)], "cpu", F64)
        return
    for fn in (level_gather_reduce, level_gather_reduce_plain):
        with pytest.raises(ValueError):
            fn(w.clone(), tables, src=src)
