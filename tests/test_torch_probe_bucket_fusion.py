"""The port of ``benchmarks/probe_bucket_fusion.py`` on the CPU, at a small
shape (S 64, B 16, A 8, C 32), in float64.

Every PyTorch formulation of the padded sum bucket, and the level kernel's
plain version on one ``SumBucket``, lies within 1e-12 of each output's
scale of ``out[c] = sum_a fac[a, c] * w[idx[a, c]]`` in numpy float64 and
of the JAX script's baseline formula in ``jax.numpy`` (the bfloat16
formulation: of the same sums on ``w`` rounded to bfloat16).  The JAX
script itself cannot be imported: it builds its full-size arrays on a
device and times them when it is loaded, so its baseline formula is
written out here.  ``main`` runs on the CPU and prints one JSON line a
measurement.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from feynmandiagram_tpu_torch.benchmarks import probe_bucket_fusion as pbf  # noqa: E402

S, B, A, C = 64, 16, 8, 32
TOL = 1e-12


def _inputs():
    w, idx2, fac2 = pbf.make_inputs(S, B, A, C, seed=3)
    return w.astype(np.float64), idx2, fac2.astype(np.float64)


def _numpy_sum(w, idx2, fac2):
    out = np.zeros((idx2.shape[1], w.shape[1]))
    for a in range(idx2.shape[0]):
        out += fac2[a][:, None] * w[idx2[a]]
    return out


def _close(got, ref):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * np.abs(ref).max())


def test_formulations_equal_the_float64_sum_and_jax():
    w, idx2, fac2 = _inputs()
    ref = _numpy_sum(w, idx2, fac2)
    ref_jax = np.asarray(jnp.sum(jnp.asarray(w)[idx2] * jnp.asarray(fac2)[:, :, None], axis=0))
    _close(ref_jax, ref)
    wt, it, ft = torch.from_numpy(w), torch.from_numpy(idx2).long(), torch.from_numpy(fac2)
    idx_flat, fac_flat, seg = pbf.csr_edges(it, ft)
    outs = {"baseline": pbf.baseline(wt, it, ft), "unrolled": pbf.unrolled(wt, it, ft),
            "scanned": pbf.scanned(wt, it, ft), "einsum": pbf.einsum_form(wt, it, ft),
            "index_add": pbf.csr_index_add(wt, idx_flat, fac_flat, seg, C),
            "sparse.mm": pbf.sparse_mm(pbf.csr_matrix(it, ft, S), wt),
            "level plain": pbf.level_kernel(torch.empty((C, B), dtype=torch.float64),
                                            pbf.bucket_tables(idx2, fac2, "cpu", torch.float64),
                                            wt, kernel=False)}
    for name, out in outs.items():
        assert out.dtype == torch.float64, name
        _close(out, ref)
        _close(out, ref_jax)
    w_half = wt.to(torch.bfloat16)
    _close(pbf.unrolled_half(w_half, it, ft), _numpy_sum(w_half.double().numpy(), idx2, fac2))


def test_csr_edges_are_sorted_by_destination():
    _, idx2, fac2 = _inputs()
    idx_flat, fac_flat, seg = pbf.csr_edges(torch.from_numpy(idx2), torch.from_numpy(fac2))
    assert torch.equal(seg, torch.arange(C).repeat_interleave(A))
    assert torch.equal(idx_flat.view(C, A), torch.from_numpy(idx2).T)
    assert torch.equal(fac_flat.view(C, A), torch.from_numpy(fac2).T)


def test_main_on_the_cpu(capsys):
    assert pbf.main(["--device", "cpu", "--shape", str(S), str(B), str(A), str(C)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "probe_bucket_fusion: every check held: True"
    rows = [json.loads(x) for x in lines[:-1]]
    checks = [r for r in rows if "check" in r]
    assert len(checks) == 2 and all(r["bit_for_bit"] for r in checks)
    timed = [r for r in rows if "name" in r]
    assert len(timed) == 9 and all(r["device"] == "cpu" and r["cpu_ms"] > 0 for r in timed)
    assert not any("device_ms" in r or "share_of_bound" in r for r in timed)
    assert all(r["max_rel_err_vs_kernel"] <= r["tol"] for r in timed if "tol" in r)


def test_the_full_shape_bound():
    """The JAX script's optimal traffic at its shapes: 1.208 GB in float32,
    0.3606 ms at 3.35 TB/s; 0.671 GB in bfloat16 with a float32 output."""
    e = pbf.A * pbf.C
    assert (e + pbf.C) * pbf.B * 4 == 1_207_959_552
    assert round((e + pbf.C) * pbf.B * 4 / pbf.HBM_BYTES_PER_S * 1e3, 4) == 0.3606
    assert (e + 2 * pbf.C) * pbf.B * 2 == 671_088_640
