"""The port's row-access probes and gather strategies on the CPU.

The reference is the JAX package's own ``benchmarks/probe_mosaic_caps.py``,
run untouched with every ``pallas_call`` in interpret mode; its case
functions read the module's ``w``, ``rows``, ``S`` and ``B``, which the
random cases replace.  The plain versions must equal it exactly: every case
moves values or adds them in the reference's order, and the one-hot product
has one nonzero term.  ``k_take`` does not trace in interpret mode
("captures constants"), so take is held to ``jnp.take``.  The CUDA kernels
themselves are checked on the card by ``chip_smoke.py``, whose one-call
library yardsticks (``probe_library_calls``) are held here to the same
reference.
"""
import functools
import os
import re
import runpy
import unittest.mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from feynmandiagram_tpu_torch.benchmarks import probe_gather as pg  # noqa: E402
from feynmandiagram_tpu_torch.benchmarks import probe_mosaic_caps as pm  # noqa: E402
from feynmandiagram_tpu_torch.ops import build  # noqa: E402
import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["dma8", "dmagrp", "vmemrow", "vmem8", "acc", "onehot", "dynwrite", "dmadyn_dst"]


def _interpret():
    return unittest.mock.patch.object(pl, "pallas_call",
                                      functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def jax_script():
    """The JAX script's globals (its cases' namespace) after one run."""
    with _interpret():
        g = runpy.run_path(os.path.join(REPO, "benchmarks", "probe_mosaic_caps.py"))
    return g["case_dma8"].__globals__


def _jax_case(ns, name, w=None, rows=None):
    """Call the JAX script's case_<name>, on its own data or on ``w``/``rows``."""
    saved = {k: ns[k] for k in ("w", "rows", "S", "B")}
    try:
        if w is not None:
            ns.update(w=jax.device_put(w), rows=jax.device_put(np.asarray(rows, np.int32)),
                      S=w.shape[0], B=w.shape[1])
        with _interpret():
            return np.asarray(ns[f"case_{name}"]())
    finally:
        ns.update(saved)


def _case(name):
    return getattr(pm, f"case_{name}")


@pytest.mark.parametrize("name", NAMES)
def test_plain_equals_interpret_reference(jax_script, name):
    w, rows = pm.probe_inputs("cpu")
    got = _case(name)(w, rows).numpy()
    ref = _jax_case(jax_script, name)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_reference_values():
    """The first values the JAX script prints on a TPU and in interpret mode."""
    w, rows = pm.probe_inputs("cpu")
    first = {name: _case(name)(w, rows).reshape(-1)[:2].tolist() for name in NAMES}
    assert first == {"dma8": [704, 705], "dmagrp": [192, 193], "vmemrow": [704, 705],
                     "vmem8": [704, 705], "acc": [2432, 2436], "onehot": [704, 705],
                     "dynwrite": [0, 0], "dmadyn_dst": [632, 633]}
    np.testing.assert_array_equal(pm.case_dynwrite(w, rows)[1].numpy(), w[0].numpy())


def test_take_matches_jnp_take():
    w, rows = pm.probe_inputs("cpu")
    ref = jnp.take(jnp.asarray(w[:256].numpy()), jnp.asarray(pm.TAKE_ROWS, jnp.int32), axis=0)
    np.testing.assert_array_equal(pm.case_take(w, rows).numpy(), np.asarray(ref))


RS, RB = 512, 256   # random cases: w is [RS, RB]


@pytest.mark.parametrize("name,rows", [
    ("dma8", (RS - 8, 3, 0, 0)),          # the last 8-row window
    ("dma8", (0, 3, 0, 0)),
    ("dmagrp", (RS - 1, 0, 0, 0)),        # the last group
    ("vmemrow", (300, 0, 0, 0)),          # clamped to row 255
    ("vmemrow", (-5, 0, 0, 0)),           # from the end: row 251
    ("vmemrow", (-300, 0, 0, 0)),         # clamped to row 0
    ("vmem8", (252, 0, 0, 0)),            # clamped to rows 248..255
    ("vmem8", (-3, 0, 0, 0)),             # from the end, then clamped
    ("acc", (-7, 255, 1000, -1000)),      # wrap, in range, clamp high, clamp low
    ("onehot", (251, 0, 0, 0)),           # rows past the block select nothing
    ("onehot", (-3, 0, 0, 0)),
    ("dynwrite", (-3, 0, 0, 0)),          # floor modulo: row 5
    ("dmadyn_dst", (RS // 8 - 1, -4, 0, 0)),   # j = -4 mod 4 = 0
])
def test_random_data_equals_interpret_reference(jax_script, name, rows):
    rng = np.random.default_rng(sum(map(abs, rows)) + len(name))
    w = rng.standard_normal((RS, RB)).astype(np.float32)
    got = _case(name)(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, _jax_case(jax_script, name, w, rows))


@pytest.mark.parametrize("b", [4, 100, 8192])
@pytest.mark.parametrize("name,r", [("dma8", 0), ("dma8", 13), ("dma8", 56), ("dmagrp", 13),
                                    ("dmagrp", 63)])
def test_copies_of_any_width_equal_interpret_reference(jax_script, name, r, b):
    """The two copies take any width that is a multiple of 4, from one
    16-byte piece to rows wider than a block's shared memory.  Exact: a copy."""
    w = np.random.default_rng(b + r).standard_normal((64, b)).astype(np.float32)
    got = _case(name)(torch.from_numpy(w), torch.tensor((r, 0, 0, 0), dtype=torch.int32))
    ref = _jax_case(jax_script, name, w, (r, 0, 0, 0))
    assert got.shape == ref.shape == (8, b)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("residue", range(8))
@pytest.mark.parametrize("group", [0, 5, RS // 8 - 1])
def test_dmagrp_takes_the_group_of_any_row(jax_script, group, residue):
    """r div 8 is the group of every r = 8 * group + residue.  Exact: a copy."""
    rows = (8 * group + residue, 0, 0, 0)
    w = np.random.default_rng(group).standard_normal((RS, 16)).astype(np.float32)
    got = pm.case_dmagrp(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, w[8 * group:8 * group + 8])
    np.testing.assert_array_equal(got, _jax_case(jax_script, "dmagrp", w, rows))


def _clamp_edges(k, size):
    """The starts on either side of each edge of dynamic_slice's clamp."""
    return {"last": k - size, "last+1": k - size + 1, "k": k, "-1": -1, "-k": -k,
            "-k-1": -k - 1, "int32_max": 2 ** 31 - 1, "int32_min": -2 ** 31}


EDGES = list(_clamp_edges(8, 1))


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("size", [1, 8])
@pytest.mark.parametrize("k", [8, 100, 256])
def test_slice_start_equals_dynamic_slice(k, size, edge):
    """Exact: the start is an integer."""
    r = _clamp_edges(k, size)[edge]
    ref = jax.lax.dynamic_slice(jnp.arange(k, dtype=jnp.int32), (np.int32(r),), (size,))
    assert pm._slice_start(r, k, size) == int(ref[0])


@pytest.mark.parametrize("edge", ["last+1", "-1", "-k-1", "int32_max"])
@pytest.mark.parametrize("s,b", [(8, 4), (8, 100), (100, 4), (100, 100), (255, 256)])
@pytest.mark.parametrize("name,size", [("vmemrow", 1), ("vmem8", 8)])
def test_slices_of_short_and_narrow_blocks_equal_interpret_reference(jax_script, name, size, s,
                                                                     b, edge):
    """Blocks of fewer than 256 rows (K = S) and widths down to one 16-byte
    piece.  Exact: a copy."""
    rows = (_clamp_edges(s, size)[edge], 0, 0, 0)
    w = np.random.default_rng(s * b + size).standard_normal((s, b)).astype(np.float32)
    got = _case(name)(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
    ref = _jax_case(jax_script, name, w, rows)
    assert got.shape == ref.shape == (size, b)
    np.testing.assert_array_equal(got, ref)


ACC_BASE = (85, 255, 0, 255)   # rows inside the block, one of them repeated


@pytest.mark.parametrize("where", [0, 1, 2, 3, "all"])
@pytest.mark.parametrize("b", [4, 100, 8192])
def test_acc_at_every_clamp_edge_equals_interpret_reference(jax_script, b, where):
    """Each of acc's four rows at every edge of the clamp, the other three
    inside the block (two of them the same row), or all four at the edge at
    once.  w has rows past the block's 256, which no start may reach.  Bit
    for bit: four adds from 0 in the reference's order."""
    w = np.random.default_rng(b).standard_normal((300, b)).astype(np.float32)
    for edge, r in _clamp_edges(pm.BLOCK_ROWS, 1).items():
        rows = (r,) * 4 if where == "all" else ACC_BASE[:where] + (r,) + ACC_BASE[where + 1:]
        got = pm.case_acc(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
        ref = _jax_case(jax_script, "acc", w, rows)
        assert got.shape == ref.shape == (1, b), edge
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=edge)


def _onehot_block(k):
    """w whose block w[:256] has k rows; for k = 256, rows past the block too."""
    rows = k if k < pm.BLOCK_ROWS else 300
    return np.random.default_rng(k).standard_normal((rows, 100)).astype(np.float32)


@pytest.mark.parametrize("anchor", ["0", "8", "k-8"])
@pytest.mark.parametrize("k", [8, 100, 256])
def test_onehot_at_every_residue_equals_interpret_reference(jax_script, k, anchor):
    """Starts r at every residue mod 8 on both sides of 0, 8 and k - 8: the
    8 selected rows partly or wholly outside the block select zeros.  Both
    designs' wrappers (the kernel of record and the tensor-core variant).
    Exact: one nonzero term."""
    w = _onehot_block(k)
    a = {"0": 0, "8": 8, "k-8": k - 8}[anchor]
    for r in range(a - 8, a + 8):
        rows = torch.tensor((r, 0, 0, 0), dtype=torch.int32)
        ref = _jax_case(jax_script, "onehot", w, (r, 0, 0, 0))
        for case in (pm.case_onehot, pm.case_onehot_mma):
            got = case(torch.from_numpy(w), rows).numpy()
            assert got.shape == ref.shape == (8, 100)
            np.testing.assert_array_equal(got, ref, err_msg=f"{case.__name__} r={r}")


@pytest.mark.parametrize("b", [4, 100, 512, 16384])
@pytest.mark.parametrize("r", chip_smoke.DYNWRITE_ROWS)
def test_dynwrite_at_every_residue_equals_interpret_reference(jax_script, r, b):
    """Row floor_mod(r, 8) of the output is w[0], the others zeros, at
    chip_smoke's rows (every residue mod 8, negative r and r past the block
    among them, int32's extremes) and widths from one 16-byte piece to 16384
    columns; w has rows past the block's 256.  Bit for bit: a copy and
    zeros; w[0] holds -0.0, infinities and a NaN."""
    w = np.random.default_rng(b + r % 8).standard_normal((300, b)).astype(np.float32)
    w[0, :4] = [-0.0, np.inf, -np.inf, np.nan]
    rows = (r, 0, 0, 0)
    ref = _jax_case(jax_script, "dynwrite", w, rows)
    want = np.zeros((8, b), np.float32)
    want[r % 8] = w[0]
    np.testing.assert_array_equal(ref.view(np.int32), want.view(np.int32))
    got = pm.case_dynwrite(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
    assert got.shape == ref.shape == (8, b)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("r", [-3, 5, 17])
@pytest.mark.parametrize("s", [1, 8])
def test_dynwrite_of_short_blocks_equals_interpret_reference(jax_script, s, r):
    """Blocks of 1 and 8 rows, as chip_smoke runs them: only row 0 is read.
    Bit for bit."""
    w = np.random.default_rng(s * 8 + r % 8).standard_normal((s, 100)).astype(np.float32)
    rows = (r, 0, 0, 0)
    ref = _jax_case(jax_script, "dynwrite", w, rows)
    got = pm.case_dynwrite(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
    assert got.shape == ref.shape == (8, 100)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_dynwrite_of_an_empty_block_raises():
    with pytest.raises(ValueError):
        pm.case_dynwrite(torch.zeros((0, 16), dtype=torch.float32),
                         torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("r", [-8, "k", 2 ** 31 - 1, -2 ** 31])
@pytest.mark.parametrize("k", [8, 100, 256])
def test_onehot_start_that_selects_nothing_equals_interpret_reference(jax_script, k, r):
    """Starts at or past the clamp into [-8, k]: all zeros, as in the
    reference (whose r + i wraps in int32 at 2^31 - 1)."""
    r = k if r == "k" else r
    w = _onehot_block(k)
    got = pm.case_onehot(torch.from_numpy(w), torch.tensor((r, 0, 0, 0), dtype=torch.int32))
    ref = _jax_case(jax_script, "onehot", w, (r, 0, 0, 0))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not ref.any()


@pytest.mark.parametrize("name", NAMES + ["take"])
def test_library_yardstick_equals_interpret_reference(jax_script, name):
    """chip_smoke's one PyTorch call for each probe, on the probe's data."""
    w, rows = pm.probe_inputs("cpu")
    got = chip_smoke.probe_library_calls(w, rows)[name]().numpy()
    if name == "take":
        ref = np.asarray(jnp.take(jnp.asarray(w[:256].numpy()),
                                  jnp.asarray(pm.TAKE_ROWS, jnp.int32), axis=0))
    else:
        ref = _jax_case(jax_script, name, w.numpy(), rows.numpy())
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rows", [(-7, 255, 1000, -1000), (250, -3, 3, 1), (3, 2, 7, 7),
                                  (-300, 256, 0, 0)])
def test_library_yardsticks_follow_the_rows(rows):
    """Away from the probe's rows each yardstick computes its probe's
    function: clamped and repeated rows (acc, vmemrow, vmem8), floor modulo
    (dynwrite), a destination outside scratch[0:8] (dmadyn_dst).  w holds
    rows 8 * r .. 8 * r + 8 for dmadyn_dst's r up to 250."""
    w = torch.from_numpy(np.random.default_rng(7).standard_normal((2104, 16)).astype(np.float32))
    rows = torch.tensor(rows, dtype=torch.int32)
    calls = chip_smoke.probe_library_calls(w, rows)
    names = ["vmemrow", "vmem8", "acc", "onehot", "dynwrite", "take"]
    if rows[0] >= 0:
        names += ["dma8", "dmagrp", "dmadyn_dst"]
    for name in names:
        plain = getattr(pm, f"case_{name}_plain")(w, rows)
        assert torch.equal(calls[name]().view(torch.int32), plain.view(torch.int32)), name


@pytest.mark.parametrize("name", ["vmemrow", "vmem8", "dma8", "dmagrp"])
def test_bulk_variant_is_the_same_function(name, monkeypatch):
    """On the CPU both run the one plain version; the variant checks its
    chunk size as well."""
    w, rows = pm.probe_inputs("cpu")
    bulk = getattr(pm, f"case_{name}_bulk")
    assert torch.equal(bulk(w, rows), _case(name)(w, rows)) and bulk.launches == 0
    with pytest.raises(ValueError):
        bulk(w.double(), rows)
    for chunk in (0, 24, 48 * 1024):
        monkeypatch.setattr(pm, "BULK_CHUNK_BYTES", chunk)
        with pytest.raises(ValueError, match="chunk"):
            bulk(w, rows)


def test_onehot_mma_is_the_same_function():
    """On the CPU the tensor-core variant runs onehot's plain version, with
    the same checks and no launch."""
    w, rows = pm.probe_inputs("cpu")
    assert torch.equal(pm.case_onehot_mma(w, rows), pm.case_onehot(w, rows))
    assert pm.case_onehot_mma.launches == 0
    for bad_w, bad_rows in ((w.double(), rows), (w, rows.long()), (w[:4], rows)):
        with pytest.raises(ValueError):
            pm.case_onehot_mma(bad_w, bad_rows)


def test_random_data_take():
    w = np.random.default_rng(5).standard_normal((RS, RB)).astype(np.float32)
    got = pm.case_take(torch.from_numpy(w), torch.zeros(4, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.take(w[:256], jnp.asarray(
        pm.TAKE_ROWS), axis=0)))


@pytest.mark.parametrize("r1", [1, 2, 3, -1, 6])
def test_dmadyn_dst_other_offsets_read_zeroed_scratch(r1):
    """For rows[1] mod 4 != 0 the copy lands outside scratch[0:8], which the
    TPU kernel left uninitialised and the port zero-fills."""
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((RS, RB)).astype(np.float32))
    out = pm.case_dmadyn_dst(w, torch.tensor([3, r1, 0, 0], dtype=torch.int32))
    assert out.shape == (8, RB) and not out.any()


@pytest.mark.parametrize("name,rows", [
    ("dma8", (RS - 7, 0, 0, 0)), ("dma8", (-1, 0, 0, 0)),
    ("dmagrp", (RS, 0, 0, 0)), ("dmagrp", (-1, 0, 0, 0)),
    ("dmadyn_dst", (RS // 8, 0, 0, 0)), ("dmadyn_dst", (-1, 0, 0, 0)),
    ("dma8_bulk", (RS - 7, 0, 0, 0)), ("dma8_bulk", (-1, 0, 0, 0)),
    ("dmagrp_bulk", (RS, 0, 0, 0)), ("dmagrp_bulk", (-1, 0, 0, 0)),
])
def test_copy_out_of_bounds_raises(name, rows):
    """The copies have no clamp: an out-of-range source raises on the host."""
    w = torch.zeros((RS, RB), dtype=torch.float32)
    with pytest.raises(ValueError, match="outside"):
        _case(name)(w, torch.tensor(rows, dtype=torch.int32))


BAD = ["w_f64", "w_ragged_rows", "w_1d", "rows_int64", "rows_short", "meta_device"]
BULK_CASES = [pm.case_dma8_bulk, pm.case_dmagrp_bulk, pm.case_vmemrow_bulk, pm.case_vmem8_bulk]


@pytest.mark.parametrize("bad", BAD + [f"{bad}-bulk" for bad in BAD])
def test_wrapper_rejects_bad_arguments(bad):
    """Every probe, and with ``-bulk`` every TMA variant, on one bad argument."""
    bad, _, bulk = bad.partition("-")
    cases = BULK_CASES if bulk else [case for _, case, _ in pm.CASES]
    w, rows = pm.probe_inputs("cpu", 64, 16)
    if bad == "w_f64":
        w = w.double()
    elif bad == "w_ragged_rows":
        w = w[:, :14].contiguous()
    elif bad == "w_1d":
        w = w.reshape(-1)
    elif bad == "rows_int64":
        rows = rows.long()
    elif bad == "rows_short":
        rows = rows[:3]
    elif bad == "meta_device":
        w = w.to("meta")
    for case in cases:
        with pytest.raises(ValueError):
            case(w, rows)


def test_dmagrp_needs_whole_groups():
    w = torch.zeros((12, 16), dtype=torch.float32)
    for case in (pm.case_dmagrp, pm.case_dmagrp_bulk):
        with pytest.raises(ValueError, match="groups of 8"):
            case(w, torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("r1", [0, 1, -4])
@pytest.mark.parametrize("b", [4, 1816, 4096])
def test_dmadyn_dst_of_any_width_equals_interpret_reference(jax_script, b, r1):
    """Any width that is a multiple of 4, past the 1812 floats a staged
    32-row scratch allowed.  Where rows[1] mod 4 == 0 the copy is the
    output, as in the JAX script; elsewhere the rows the TPU kernel left
    uninitialised are zeros.  Exact: a copy."""
    rows = (64 // 8 - 1, r1, 0, 0)   # the last group of 8 of w's 64 rows
    w = np.random.default_rng(b + r1 % 4).standard_normal((64, b)).astype(np.float32)
    got = pm.case_dmadyn_dst(torch.from_numpy(w), torch.tensor(rows, dtype=torch.int32)).numpy()
    ref = _jax_case(jax_script, "dmadyn_dst", w, rows) if r1 % 4 == 0 else np.zeros((8, b),
                                                                                   np.float32)
    assert got.shape == ref.shape == (8, b)
    np.testing.assert_array_equal(got, ref)
    if r1 % 4 == 0:
        np.testing.assert_array_equal(got, w[56:64])


@pytest.mark.parametrize("b", [4, 100])
@pytest.mark.parametrize("s", [10, 100, 256, 300])
def test_take_of_any_block_equals_jnp_take(s, b):
    """Blocks from the 10 rows take needs to past 256 rows, where only
    w[:256] is the block.  Exact: a copy."""
    w = np.random.default_rng(s * b).standard_normal((s, b)).astype(np.float32)
    got = pm.case_take(torch.from_numpy(w), torch.zeros(4, dtype=torch.int32)).numpy()
    ref = np.asarray(jnp.take(jnp.asarray(w[:256]), jnp.asarray(pm.TAKE_ROWS, jnp.int32), axis=0))
    assert got.shape == ref.shape == (8, b)
    np.testing.assert_array_equal(got, ref)


def test_take_kernel_rows_are_take_rows():
    """k_take's rows are the nibbles of kTakeRowsPacked, from the lowest; no
    CPU runs the kernel, so its constant is read from the source."""
    with open(os.path.join(REPO, "feynmandiagram_tpu_torch", "csrc", "row_probes.cu")) as f:
        packed = re.search(r"kTakeRowsPacked = (0x[0-9a-fA-F]+)u;", f.read())
    assert packed is not None
    value = int(packed.group(1), 16)
    assert tuple((value >> (4 * i)) & 0xF for i in range(8)) == pm.TAKE_ROWS


def test_cpu_path_does_not_count_launches():
    w, rows = pm.probe_inputs("cpu")
    before = [case.launches for _, case, _ in pm.CASES]
    for _, case, _ in pm.CASES:
        case(w, rows)
    assert [case.launches for _, case, _ in pm.CASES] == before


def test_row_probes_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build("row_probes")


# ---- probe_gather's strategies at S = 256, B = 128, E = 512

GS, GB, GE, GW, GC = 256, 128, 512, 128, 64


@pytest.fixture(scope="module")
def gather_inputs():
    return pg.make_inputs("cpu", GS, GB, GE, GW, GC)


def test_inputs_follow_the_script_draws(gather_inputs):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((GS, GB)).astype(np.float32)
    idx = rng.integers(0, GS, size=GE).astype(np.int32)
    fac = rng.standard_normal(GE).astype(np.float32)
    col = rng.integers(0, GW, GC)
    x = gather_inputs
    np.testing.assert_array_equal(x["w"].numpy(), w)
    np.testing.assert_array_equal(x["idx"].numpy(), idx)
    np.testing.assert_array_equal(x["idx_sorted"].numpy(), np.sort(idx))
    np.testing.assert_array_equal(x["fac"].numpy(), fac)
    np.testing.assert_array_equal(x["onehot"].numpy().argmax(axis=1), col)
    assert x["onehot"].sum() == GC and x["w_ext"].shape == (GS + GE // 8, GB)


@pytest.mark.parametrize("strategy", ["stream", "gather", "take", "take_sorted"])
def test_gather_strategy_equals_jax(gather_inputs, strategy):
    x = gather_inputs
    w, idx, srt = (x[k].numpy() for k in ("w", "idx", "idx_sorted"))
    wj = jnp.asarray(w)
    got, ref = {
        "stream": (lambda: pg.stream(x["w"]), lambda: wj * 2.0),
        "gather": (lambda: pg.gather(x["w"], x["idx"]), lambda: wj[idx]),
        "take": (lambda: pg.take(x["w"], x["idx"]), lambda: jnp.take(wj, idx, axis=0)),
        "take_sorted": (lambda: pg.take(x["w"], x["idx_sorted"]),
                        lambda: wj.at[srt].get(mode="promise_in_bounds",
                                               indices_are_sorted=True)),
    }[strategy]
    np.testing.assert_array_equal(got().numpy(), np.asarray(ref()))


@pytest.mark.parametrize("through_kernel", [False, True])
def test_gather_scale_sum_equals_jax(gather_inputs, through_kernel):
    """The 8-way reduce of the script's :50-53.  The sums of 8 float32 terms
    are taken in another order: rtol 1e-6 of the terms' size."""
    x = gather_inputs
    w, idx, fac = (x[k].numpy() for k in ("w", "idx", "fac"))
    g = jnp.asarray(w).at[idx].get(mode="promise_in_bounds") * fac[:, None]
    ref = np.asarray(jnp.sum(g.reshape(8, GE // 8, GB), axis=0))
    if through_kernel:
        got = pg.gather_scale_sum_kernel(x["w_ext"].clone(), GS,
                                         pg.bucket_level(x["idx"], x["fac"], GS))
    else:
        got = pg.gather_scale_sum(x["w"], x["idx"], x["fac"])
    size = np.abs(w[idx] * fac[:, None]).reshape(8, GE // 8, GB).sum(axis=0)
    assert got.shape == ref.shape
    assert np.all(np.abs(got.numpy() - ref) <= 1e-6 * size)


def test_onehot_equals_jax(gather_inputs):
    x = gather_inputs
    sel, win = x["onehot"].numpy(), x["w"][:GW].numpy()
    ref = jnp.dot(sel, win, preferred_element_type=jnp.float32)
    np.testing.assert_array_equal(pg.onehot(x["onehot"], x["w"][:GW]).numpy(),
                                  np.asarray(ref))
