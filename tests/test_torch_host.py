"""The port's own host pipeline against the JAX package's.

Both packages generate, optimize and lower the same diagrams, each with its
own front end, graph IR and ``ops/lowering.py``, and must give identical
``LoweredGraph``s.  Tolerance: none.  These are integer tables and copied
factors, so every array is compared with ``np.array_equal``.  The native and
the numpy ``cse``/``depth`` of the port agree with the reference's on the
same record arrays.

Other test files import this one's helpers: ``generate`` (a diagram set from
either package) and ``to_port`` (a reference graph carried into the port's
classes).
"""
import dataclasses
import importlib
import io
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import feynmandiagram_tpu.native as ref_native  # noqa: E402
import feynmandiagram_tpu_torch.native as port_native  # noqa: E402

REF, PORT = "feynmandiagram_tpu", "feynmandiagram_tpu_torch"


def generate(pkg, kind, order, level=1):
    """``(roots, para)`` of the order-``order`` Gamma4 (``vertex4``) or
    self-energy (``sigma``) diagrams, generated and optimized by package
    ``pkg``."""
    fe = importlib.import_module(f"{pkg}.frontends")
    pq = importlib.import_module(f"{pkg}.frontends.parquet")
    cg = importlib.import_module(f"{pkg}.computational_graph")
    para = pq.DiagPara(type=pq.Ver4Diag if kind == "vertex4" else pq.SigmaDiag,
                       innerLoopNum=order, hasTau=True, filter=(fe.NoHartree,),
                       interaction=(pq.Interaction(fe.ChargeCharge, fe.Instant),))
    if kind == "vertex4":
        rows = pq.vertex4(para)
    else:
        extK = np.zeros(para.totalLoopNum)
        extK[0] = 1.0
        rows = pq.sigma(para, extK, False)
    roots = [r["diagram"] for r in rows]
    cg.optimize_inplace(roots, level=level)
    return roots, para


def lower_with(pkg, roots, **kw):
    compile_mod = importlib.import_module(f"{pkg}.backends.compile")
    lowering = importlib.import_module(f"{pkg}.ops.lowering")
    return lowering.lower(roots, compile_mod.leafmap_of(roots), **kw)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == REF or module.startswith(REF + "."):
            module = PORT + module[len(REF):]
        return super().find_class(module, name)


def to_port(obj):
    """A copy of ``obj`` (graphs of the JAX package, with their ids and
    properties) made of the port's classes of the same names."""
    return _PortUnpickler(io.BytesIO(pickle.dumps(obj))).load()


def assert_same_lowering(a, b):
    assert a.num_slots == b.num_slots and a.num_leaves == b.num_leaves
    assert a.num_edges == b.num_edges and len(a.levels) == len(b.levels)
    for name in ("root_slots", "const_slots", "const_values"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    # leaves take their slots in the same order, whatever their uids
    assert sorted(a.leaf_uid_to_slot.values()) == sorted(b.leaf_uid_to_slot.values())
    for li, (la, lb) in enumerate(zip(a.levels, b.levels)):
        assert (la.sums is None) == (lb.sums is None), li
        plans = ([(la.sums, lb.sums)] if la.sums is not None else [])
        for name in ("prods", "pows", "sum_buckets", "fused"):
            pa, pb = getattr(la, name), getattr(lb, name)
            assert len(pa) == len(pb), (li, name)
            plans += list(zip(pa, pb))
        for pa, pb in plans:
            assert type(pa).__name__ == type(pb).__name__
            for f in dataclasses.fields(pa):
                x, y = getattr(pa, f.name), getattr(pb, f.name)
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and x.shape == y.shape, (li, f.name)
                    assert np.array_equal(x, y), (li, type(pa).__name__, f.name)
                else:
                    assert x == y, (li, type(pa).__name__, f.name)


# sigma at orders 1-3 and vertex4 at orders 1-3 need no table beyond
# groups_vertex4; order-4 vertex4 is generated once for the module
SMALL = [("vertex4", 1), ("vertex4", 2), ("vertex4", 3),
         ("sigma", 1), ("sigma", 2), ("sigma", 3)]
MODES = [(m, c) for m in ("fused", "bucketed") for c in (True, False)]


@pytest.fixture(scope="module")
def generated():
    cache = {}

    def get(kind, order):
        if (kind, order) not in cache:
            cache[kind, order] = (generate(REF, kind, order)[0],
                                  generate(PORT, kind, order)[0])
        return cache[kind, order]

    return get


@pytest.mark.parametrize("sum_mode,cse", MODES)
@pytest.mark.parametrize("kind,order", SMALL)
def test_lowerings_identical(generated, kind, order, sum_mode, cse):
    ref_roots, port_roots = generated(kind, order)
    assert len(ref_roots) == len(port_roots) > 0
    assert type(port_roots[0]).__module__.startswith(PORT + ".")
    assert_same_lowering(lower_with(PORT, port_roots, sum_mode=sum_mode, cse=cse),
                         lower_with(REF, ref_roots, sum_mode=sum_mode, cse=cse))


@pytest.mark.parametrize("sum_mode,cse", MODES)
def test_order4_vertex4_lowerings_identical(generated, sum_mode, cse):
    ref_roots, port_roots = generated("vertex4", 4)
    assert_same_lowering(lower_with(PORT, port_roots, sum_mode=sum_mode, cse=cse),
                         lower_with(REF, ref_roots, sum_mode=sum_mode, cse=cse))


def test_to_port_carries_graphs_across(generated):
    ref_roots, port_roots = generated("vertex4", 2)
    carried = to_port(ref_roots)
    assert all(type(g).__module__.startswith(PORT + ".") for g in carried)
    assert [g.id for g in carried] == [g.id for g in ref_roots]
    assert_same_lowering(lower_with(PORT, carried, sum_mode="fused"),
                         lower_with(PORT, port_roots, sum_mode="fused"))


def _records(seed, n=400):
    """Postordered record arrays as ``_cse_records`` builds them: leaves
    first, children before parents, with planted duplicates."""
    rng = np.random.default_rng(seed)
    n_leaf = 12
    ops = np.zeros(n, np.int8)
    powers = np.zeros(n, np.int32)
    prop = np.zeros(n, np.uint64)
    kids, facs = [[] for _ in range(n)], [[] for _ in range(n)]
    prop[:n_leaf] = np.arange(n_leaf, dtype=np.uint64) + 100
    for i in range(n_leaf, n):
        if i > n_leaf + 5 and rng.random() < 0.3:
            j = int(rng.integers(n_leaf, i))     # a structural duplicate of node j
            ops[i], powers[i] = ops[j], powers[j]
            kids[i], facs[i] = list(kids[j])[::-1], list(facs[j])[::-1]
            continue
        ops[i] = rng.choice([1, 2, 3])
        k = 1 if ops[i] == 3 else int(rng.integers(2, 5))
        powers[i] = int(rng.integers(2, 4)) if ops[i] == 3 else 0
        kids[i] = [int(c) for c in rng.integers(0, i, k)]
        facs[i] = [float(f) for f in rng.choice([1.0, -1.0, 0.5, 2.0], k)]
    counts = np.array([len(k) for k in kids], np.int64)
    edge_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=edge_ptr[1:])
    edge_src = np.array([c for k in kids for c in k], np.int64)
    edge_fac = np.array([f for k in facs for f in k], np.float64)
    return ops, powers, prop, edge_ptr, edge_src, edge_fac


@pytest.fixture
def numpy_path(monkeypatch):
    """Run the port's ``native`` on its numpy path."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_build_failed", True)
    assert not port_native.native_available()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_cse_and_depth_match_reference(seed):
    if not port_native.native_available():
        pytest.skip("no g++ on this machine: the port's native library did not build")
    rec = _records(seed)
    remap, n_canon = port_native.cse(*rec)
    ref_remap, ref_canon = ref_native.cse(*rec)
    assert n_canon == ref_canon < len(rec[0]) and np.array_equal(remap, ref_remap)
    assert np.array_equal(port_native.depth(rec[3], rec[4]), ref_native.depth(rec[3], rec[4]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_cse_and_depth_match_reference(numpy_path, seed):
    rec = _records(seed)
    remap, n_canon = port_native.cse(*rec)
    ref_remap, ref_canon = ref_native.cse(*rec)
    assert n_canon == ref_canon and np.array_equal(remap, ref_remap)
    assert np.array_equal(port_native.depth(rec[3], rec[4]), ref_native.depth(rec[3], rec[4]))


def test_native_library_builds_outside_the_sources():
    """The port builds its helper into its own ``_build`` directory, never
    beside the sources or into the JAX package."""
    import os
    from feynmandiagram_tpu_torch.ops import build
    if not port_native.native_available():
        pytest.skip("no g++ on this machine: the port's native library did not build")
    assert os.path.exists(os.path.join(build.BUILD_DIR, "libgraphcore.so"))
    assert os.path.basename(build.BUILD_DIR) == "_build"
    assert not [f for f in os.listdir(build.SRC_DIR) if f.endswith(".so")]


def test_numpy_path_lowers_identically(numpy_path, generated):
    ref_roots, port_roots = generated("vertex4", 2)
    assert_same_lowering(lower_with(PORT, port_roots, sum_mode="fused", cse=True),
                         lower_with(REF, ref_roots, sum_mode="fused", cse=True))
