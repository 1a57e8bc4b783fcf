"""The port's bucket gather-reduce on the CPU: its plain version against
the JAX package's Pallas kernel (interpret mode) and against numpy, and the
wrapper's checks.  The CUDA kernel itself is checked on the card by
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from feynmandiagram_tpu.ops.kernels import bucket_gather_reduce as jax_bucket  # noqa: E402
from feynmandiagram_tpu_torch.ops import kernels  # noqa: E402
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
    monkeypatch.setattr(kernels, "_LIB_PATH", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
