"""The counting functions and the trace arithmetic, on tiny lowerings and
synthetic intervals, and the kernel readers on a synthetic trace."""
import numpy as np
import pytest

from portbench import bench, counting
from portbench.trace import Trace, gaps, union_length


def test_short_name():
    from portbench.trace import short_name

    assert short_name("void (anonymous namespace)::gather_reduce_kernel<float, float, 4, "
                      "false>(float*, float const*)") == "gather_reduce_kernel"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    assert short_name("memcpy128") == "memcpy128"


def test_union_length():
    assert union_length([]) == 0
    assert union_length([(0, 1), (2, 3)]) == 2
    assert union_length([(0, 2), (1, 3), (1.5, 1.7)]) == 3
    assert union_length([(5, 6), (0, 10)]) == 10


def test_gaps():
    assert gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert gaps([(0, 3), (1, 2)], 0, 3) == []
    assert gaps([], 0, 2) == [(0, 2)]


class _Bucket:
    def __init__(self, idx, start=0):
        self.idx, self.start = np.asarray(idx), start
        self.count = self.idx.shape[-1]


class _Level:
    def __init__(self, sum_buckets=(), fused=(), prods=(), pows=()):
        self.sum_buckets, self.fused, self.prods, self.pows = (
            list(sum_buckets), list(fused), list(prods), list(pows))


class _Prod:
    def __init__(self, idx):
        self.idx = np.asarray(idx)
        self.arity = self.idx.shape[0]


class _Pow:
    def __init__(self, src, n):
        self.src, self.n = np.asarray(src), n


class _Lowered:
    def __init__(self, levels):
        self.levels = levels


def test_level_bounds_count_distinct_rows_once():
    # level 0: a sum bucket of arity 2 over 3 outputs reading rows {0, 1, 2};
    # a fused bucket of 2 operands, arity 1, 2 outputs reading {1, 5, 6}.
    # Distinct rows read 5, written 5; level 1: a product of 3 operands
    # reading {7, 8} once, a power of 2 reading {9}, an arity-5 product
    # (plain, left out), written 2.
    lvl0 = _Level(sum_buckets=[_Bucket([[0, 1, 2], [1, 2, 0]])],
                  fused=[_Bucket([[[1, 5]], [[5, 6]]])])
    lvl1 = _Level(prods=[_Prod([[7], [8], [7]]), _Prod(np.zeros((5, 1), int))],
                  pows=[_Pow([9], 2)])
    empty = _Level()
    out = counting.level_bounds(_Lowered([lvl0, empty, lvl1]), batch=1000, elsize=4)
    assert [(b["rows_read"], b["rows_written"]) for b in out] == [(5, 5), (3, 2)]
    assert out[0]["s"] == pytest.approx(10 * 1000 * 4 / counting.HBM_BYTES_PER_S)
    assert all(b["by"] == "bytes" for b in out)


class _Tables:
    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, np.asarray(v))


def test_leaf_operations_and_bound():
    # two momenta: row 0 = loop 0 (one entry), row 1 = loop 0 - 2 loop 1
    # (two entries, one not +-1).  Leaves: a bare G on row 0 (times 1->2),
    # an order-2 G counterterm on row 1 (times 1->2), an order-1 V on row 1.
    t = _Tables(leaf_type=[1, 1, 2], g_order=[0, 2, 0], v_order=[0, 0, 1],
                tau_in=[1, 1, 1], tau_out=[2, 2, 1], loop_idx=[0, 1, 1],
                loop_basis=[[1.0, 0.0], [1.0, -2.0]])
    row0 = 3 * 0 + 5 + 1 + 4           # |k|^2; eps; softplus
    row1 = 3 * (1 + 1) + 5 + 1 + 4 + 2  # entries; |k|^2; eps; sigmoid; q^2 + lam, 1/x
    pairs = 2 * 1
    leaves = 3 + (3 + 2 * 2) + 2
    assert counting.leaf_operations(t) == row0 + row1 + pairs + leaves
    b = counting.leaf_bound(t, batch=100, sample_bytes=40, elsize=4)
    assert b["s"] == pytest.approx((40 + 3 * 4) * 100 / counting.HBM_BYTES_PER_S)


def _facts(kind, trace, units, window=None):
    return bench.Facts(kind=kind, setup_s=12.0, host_build_s=5.0, window=window or {},
                       batch=100, store_bytes=4, sample_bytes=40, lowered=None,
                       leaf_tables=None, trace=trace, trace_units=units)


def test_kernel_readers_on_a_synthetic_trace():
    ops = [("void leaf_eval_kernel<double>(...)", 0.0, 0.001),
           ("void gather_reduce_kernel<float>(...)", 0.001, 0.004),
           ("void gather_reduce_kernel<float>(...)", 0.005, 0.007),
           ("Memcpy HtoD", 0.0065, 0.0075)]
    trace = Trace(window_s=0.01, ops=ops, host=[("cudaGraphLaunch", 0.0035, 0.0055)])
    facts = _facts("mc", trace, 2)
    assert bench.reader("leaf_kernel_ms.mc")(facts) == pytest.approx(0.5)
    assert bench.reader("level_kernels_ms.mc")(facts) == pytest.approx(2.5)
    assert bench.reader("device_idle.mc")(facts) == pytest.approx(100 * (1 - 0.0065 / 0.01))
    assert bench.reader("device_idle.call")(facts) is None
    assert bench.reader("leaf_kernel_ms.mc")(_facts("call", trace, 2)) is None
    assert bench.reader("leaf_kernel_ms.mc")(_facts("mc", Trace(0.01, ops[1:]), 2)) is None
    br = trace.breakdown()
    assert br["device_ops"][0] == ["gather_reduce_kernel", pytest.approx(0.005)]
    assert br["idle_gaps"][0] == ["no host record", pytest.approx(0.0025)]
    assert br["idle_gaps"][1] == ["cudaGraphLaunch", pytest.approx(0.001)]


def test_host_clock_readers():
    facts = _facts("call", None, 0, {"window_s": 2.0, "call_ms": list(range(1, 101)),
                                     "dispatch_ms": [0.5, 0.7, 0.6]})
    assert bench.reader("call_ms_p95")(facts) == pytest.approx(95.05)
    assert bench.reader("dispatch_host_ms.call")(facts) == pytest.approx(0.6)
    assert bench.reader("samples_per_s")(facts) is None
    assert bench.reader("setup_s")(facts) == 12.0 and bench.reader("host_build_s")(facts) == 5.0
    mc = _facts("mc", None, 0, {"window_s": 2.0, "samples": 1000})
    assert bench.reader("samples_per_s")(mc) == 500
    assert bench.reader("call_ms_p95")(mc) is None
