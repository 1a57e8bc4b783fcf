"""The readers of the program's own spans, counters and phases on synthetic
traces and phase lists: ``level_excess_us.mc``, ``replay_gap_us.mc``,
``entry_host_ms.call``, ``frontend_s`` and ``compile_s``, each read where
what it reads matches and ``None`` where a record is missing, a count
differs or the cell is of the wrong kind."""
import contextlib

import pytest

from portbench import bench, counting
from portbench.tests.test_portbench_counting import _Bucket, _Level, _Lowered
from portbench.trace import Trace

BATCH, ELSIZE = 1000, 4
LEAF = "void (anonymous namespace)::leaf_eval_kernel<double>(Args)"
LEVEL = "void gather_reduce_kernel<float, float, 4, false>(float*, float const*)"
# one replay's device operations: the draws, the leaf kernel, the two level
# launches with a copy between them, the batch sum
REPLAY_OPS = ["void at::native::normal_kernel<float>()", LEAF, LEVEL,
              "void at::native::index_elementwise_kernel<8>()", LEVEL,
              "void at::native::reduce_kernel<512, 1>()"]
PREFIX, SUFFIX = "void at::native::FillFunctor<float>()", "Memcpy DtoD (Device -> Device)"
LEVEL_US = (5.0, 7.0)       # each level launch's device time, every pass
STARTS = (0.001, 0.011, 0.0215)    # each replay's start: gaps of 1500 and 2000 us


def _lowered():
    """Three levels, the middle one with nothing for the kernel."""
    return _Lowered([_Level(sum_buckets=[_Bucket([[0, 1, 2]])]), _Level(),
                     _Level(fused=[_Bucket([[[1, 5]], [[5, 6]]])])])


@contextlib.contextmanager
def _manifest(paths):
    """A manifest of the program, recorded as a capture records it, of one
    launch at each scope path (``leaf``: the leaf kernel; else a level's);
    alive while the block runs."""
    from feynmandiagram_tpu_torch.ops import kernels, leaf_eval
    from feynmandiagram_tpu_torch.utils import profiling

    with profiling.capturing() as m:
        for path in paths:
            with contextlib.ExitStack() as scopes:
                for name in path.split("/"):
                    scopes.enter_context(profiling.scope(name))
                profiling.launched(leaf_eval.leaf_eval if path == "leaf"
                                   else kernels.level_gather_reduce)
    yield m


def _mc_trace(graph, n=3, drop=None, prefix=PREFIX):
    """``n`` replays of graph ``graph`` (REPLAY_OPS, 1 ms an operation but
    the level launches), led by ``prefix`` and followed by SUFFIX; ``drop``
    leaves out that operation of the middle replay."""
    ops = [(prefix, 0.0, 0.0005)]
    host = [("mc.chunk", 0.0, 0.03)]
    for k in range(n):
        t = STARTS[k]
        host.append((f"replay:{graph}", t - 0.0008, t - 0.0007))
        levels = iter(LEVEL_US)
        for j, name in enumerate(REPLAY_OPS):
            length = next(levels) * 1e-6 if name == LEVEL else 0.001
            if not (k == 1 and j == drop):
                ops.append((name, t, t + length))
            t += 0.0015
    ops.append((SUFFIX, 0.0301, 0.0302))
    return Trace(window_s=0.031, ops=ops[::-1], host=host)


def _facts(kind, trace, units):
    return bench.Facts(kind=kind, setup_s=12.0, host_build_s=5.0, window={}, batch=BATCH,
                       store_bytes=ELSIZE, sample_bytes=40, lowered=_lowered(),
                       leaf_tables=None, trace=trace, trace_units=units)


@pytest.fixture
def graph():
    with _manifest(["leaf", "gL00/sb1", "gL02/fb1"]) as m:
        yield m


def test_level_excess_labels_the_records_by_level(graph):
    read = bench.reader("level_excess_us.mc")
    bounds = [1e6 * b["s"] for b in counting.level_bounds(_lowered(), BATCH, ELSIZE)]
    want = sorted(LEVEL_US[i] - bounds[i] for i in (0, 1) for _ in range(3))
    assert read(_facts("mc", _mc_trace(graph.name), 3)) == pytest.approx(
        (want[2] + want[3]) / 2)


def test_replay_gap_cuts_the_trace_into_its_replays(graph):
    read = bench.reader("replay_gap_us.mc")
    assert read(_facts("mc", _mc_trace(graph.name), 3)) == pytest.approx(
        1e6 * ((0.011 - (0.001 + 5 * 0.0015 + 0.001))
               + (0.0215 - (0.011 + 5 * 0.0015 + 0.001))) / 2)
    two = _mc_trace(graph.name, n=2)
    assert read(_facts("mc", two, 2)) == pytest.approx(
        1e6 * (0.011 - (0.001 + 5 * 0.0015 + 0.001)))


@pytest.mark.parametrize("metric", ["level_excess_us.mc", "replay_gap_us.mc"])
def test_manifest_readers_read_nothing_that_does_not_match(graph, metric):
    read = bench.reader(metric)
    sound = _mc_trace(graph.name)
    assert read(_facts("mc", sound, 3)) is not None
    assert read(_facts("call", sound, 3)) is None                      # the wrong kind
    assert read(_facts("mc", None, 3)) is None                         # no trace
    assert read(_facts("mc", sound, 4)) is None                        # a count mismatch
    assert read(_facts("mc", _mc_trace(graph.name, drop=4), 3)) is None  # a level record lost
    assert read(_facts("mc", _mc_trace("g-none"), 3)) is None         # no such manifest
    parent = Trace(sound.window_s, sound.ops, [h for h in sound.host if h[0] == "mc.chunk"])
    assert read(_facts("mc", parent, 3)) is None                       # no replay spans
    two = Trace(sound.window_s, sound.ops, sound.host + [("replay:g-other", 0.02, 0.021)])
    assert read(_facts("mc", two, 3)) is None                          # two graphs


def test_level_excess_needs_the_lowerings_kernel_levels():
    read = bench.reader("level_excess_us.mc")
    with _manifest(["leaf", "gL00/sb1", "gL01/fb1"]) as wrong:
        assert read(_facts("mc", _mc_trace(wrong.name), 3)) is None
    with _manifest(["leaf", "gL00/sb1", "fb1"]) as untagged:
        assert read(_facts("mc", _mc_trace(untagged.name), 3)) is None


def test_replay_gap_reads_nothing_from_an_ambiguous_cut(graph):
    read = bench.reader("replay_gap_us.mc")
    assert read(_facts("mc", _mc_trace(graph.name, drop=1), 3)) is None  # the leaf's lost
    # a lead that repeats a replay's last operation: two cuts fit
    assert read(_facts("mc", _mc_trace(graph.name, prefix=REPLAY_OPS[-1]), 3)) is None
    assert read(_facts("mc", _mc_trace(graph.name, n=1), 1)) is None   # no gap


def test_entry_host_ms_reads_the_programs_call_spans():
    read = bench.reader("entry_host_ms.call")
    host = [("call", 0.0, 0.001), ("leaf", 0.0002, 0.0003), ("call", 0.002, 0.005),
            ("cudaMemcpyAsync", 0.004, 0.0045)]
    trace = Trace(window_s=0.006, ops=[("Memcpy HtoD", 0.0001, 0.0002)], host=host)
    assert read(_facts("call", trace, 2)) == pytest.approx(2.0)
    assert read(_facts("call", trace, 3)) is None                      # a span missing
    assert read(_facts("mc", trace, 2)) is None                        # the wrong kind
    assert read(_facts("call", None, 2)) is None
    assert read(_facts("call", Trace(0.006, trace.ops, host[1::2]), 2)) is None  # the parent


def _phases(monkeypatch, records):
    from feynmandiagram_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "phases",
                        lambda: [profiling.Phase(*r) for r in records])


def test_phase_readers_sum_the_top_level_phases(monkeypatch):
    frontend, compile_s = bench.reader("frontend_s"), bench.reader("compile_s")
    facts = _facts("mc", None, 0)
    _phases(monkeypatch, [("vertex4", "sigma", 1.0, 1.5), ("sigma", None, 1.0, 3.0),
                          ("optimize_inplace", None, 3.0, 3.25),
                          ("optimize_inplace", "taylorAD", 3.5, 3.75),
                          ("taylorAD", None, 3.25, 4.0), ("optimize_inplace", None, 4.0, 4.5),
                          ("lower", "compile_evaluator", 4.5, 5.0),
                          ("leaf_tables", "compile_evaluator", 5.0, 5.25),
                          ("upload", "compile_evaluator", 5.25, 5.5),
                          ("compile_evaluator", None, 4.5, 5.625)])
    assert frontend(facts) == pytest.approx(3.5)
    assert compile_s(facts) == pytest.approx(1.125)
    assert frontend(_facts("call", None, 0)) == pytest.approx(3.5)


def test_phase_readers_read_nothing_without_phases(monkeypatch):
    from feynmandiagram_tpu_torch.utils import profiling

    frontend, compile_s = bench.reader("frontend_s"), bench.reader("compile_s")
    facts = _facts("mc", None, 0)
    _phases(monkeypatch, [])
    assert frontend(facts) is None and compile_s(facts) is None
    _phases(monkeypatch, [("vertex4", None, 0.0, 1.0)])
    assert frontend(facts) is None and compile_s(facts) is None         # never compiled
    _phases(monkeypatch, [("compile_evaluator", None, 0.0, 1.0)])
    assert frontend(facts) is None and compile_s(facts) == 1.0          # no front end
    _phases(monkeypatch, [("compile_evaluator", None, 0.0, 1.0),
                          ("compile_evaluator", None, 1.0, 2.0)])
    assert compile_s(facts) is None and frontend(facts) is None         # compiled twice
    monkeypatch.delattr(profiling, "phases")                           # the parent program
    assert frontend(facts) is None and compile_s(facts) is None
