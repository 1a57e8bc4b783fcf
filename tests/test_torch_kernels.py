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
    before = bucket_gather_reduce.launches
    bucket_gather_reduce(w, idx, fac, 8)
    assert bucket_gather_reduce.launches == before


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
