"""``correct`` comes out false when the timed path is broken underneath.

Each test drives the rest of a run on the CPU (the look for a card skipped,
the CUDA graph stood in for, a configuration cut to order 2) with one fault
planted in the program's timed path: a pass that leaves the state as it
was, half of the batch left out and the mean taken over the rest, an answer
altered where it is produced, and the program's own lower-precision path
(bfloat16 storage) in place of float32.  The cells run on one card, so no
exchange between cards can be left out.  The sound run of each comes out
correct.
"""
import time

import pytest
import torch

from portbench import bench
from portbench.tests._cells import CALL_TRAFFIC, MC_TRAFFIC, SEED, small_cell

# the benchmark's own limits: those of its Gamma4 cells (config 4's are the same)
LIMITS = {**bench.load_cell("gamma4-o4.mc-16384").limits,
          **bench.load_cell("gamma4-o4.call-4096").limits}


def _run(cell, **kw):
    return bench.run(cell, seed=SEED, seconds=0.3, trace=False, device="cpu",
                     t_start=time.perf_counter(), **kw)


def _mc(config):
    return small_cell(config, MC_TRAFFIC, {"sum_err": LIMITS["sum_err"]})


def _call():
    return small_cell("gamma4-o4", CALL_TRAFFIC, {"root_err": LIMITS["root_err"]})


def _break_roots(monkeypatch, fault):
    """Plant ``fault`` (roots -> roots) in every pass's roots, eager and static."""
    from feynmandiagram_tpu_torch.backends import compile as compile_mod

    eager = compile_mod.eager_pass

    def eager_pass(leaf_fn, graph_fn):
        fn = eager(leaf_fn, graph_fn)
        return lambda varK, varT: fault(fn(varK, varT))

    static = compile_mod.CompiledEvaluator.static_pass

    def static_pass(self, batch):
        body = static(self, batch)
        return lambda varK, varT: fault(body(varK, varT))

    monkeypatch.setattr(compile_mod, "eager_pass", eager_pass)
    monkeypatch.setattr(compile_mod.CompiledEvaluator, "static_pass", static_pass)


def _half_batch(roots):
    half = roots.shape[1] // 2
    return torch.cat([roots[:, :half] * 2, torch.zeros_like(roots[:, half:])], dim=1)


def _altered(roots):
    """One answer of the pass off by its root's largest magnitude."""
    out = roots.clone()
    out[0, 0] += roots[0].abs().max()
    return out


@pytest.mark.parametrize("config", ["gamma4-o4", "sigma4-ct2"])
def test_sound_mc_runs_are_correct(cpu_capture, config):
    r = _run(_mc(config))
    assert r["correct"] and r["checks"]["sum_err"]["value"] < 1e-6


def test_a_sound_call_run_is_correct():
    r = _run(_call())
    assert r["correct"] and r["checks"]["root_err"]["value"] < 1e-6


@pytest.mark.parametrize("config", ["gamma4-o4", "sigma4-ct2"])
def test_mc_pass_that_leaves_the_state_unchanged(cpu_capture, monkeypatch, config):
    from feynmandiagram_tpu_torch import mc

    run = mc.CapturedLoop.run

    def stale(self, seed, iters):
        run(self, seed, iters)
        self.acc.zero_()
        return self.acc.clone()

    monkeypatch.setattr(mc.CapturedLoop, "run", stale)
    assert not _run(_mc(config))["correct"]


@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "altered"])
@pytest.mark.parametrize("config", ["gamma4-o4", "sigma4-ct2"])
def test_mc_faults_in_the_roots(cpu_capture, monkeypatch, config, fault):
    _break_roots(monkeypatch, fault)
    r = _run(_mc(config))
    assert not r["correct"] and r["failed"] == 1


@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "altered"])
def test_call_faults_in_the_roots(monkeypatch, fault):
    _break_roots(monkeypatch, fault)
    assert not _run(_call())["correct"]


def test_call_that_returns_the_previous_answer(monkeypatch):
    from feynmandiagram_tpu_torch.backends import compile as compile_mod

    eager = compile_mod.eager_pass

    def eager_pass(leaf_fn, graph_fn):
        fn = eager(leaf_fn, graph_fn)
        last = []

        def stale(varK, varT):
            out = fn(varK, varT)
            last.append(out.clone())
            return last[-2] if len(last) > 1 else out

        return stale

    monkeypatch.setattr(compile_mod, "eager_pass", eager_pass)
    assert not _run(_call())["correct"]


@pytest.mark.parametrize("config", ["gamma4-o4", "sigma4-ct2"])
def test_mc_control_in_bfloat16_fails(cpu_capture, config):
    r = _run(_mc(config), dtype="bfloat16", acc_dtype="float32")
    assert not r["correct"] and r["checks"]["sum_err"]["value"] > 10 * LIMITS["sum_err"]


def test_call_control_in_bfloat16_fails():
    r = _run(_call(), dtype="bfloat16", acc_dtype="float32")
    assert not r["correct"] and r["checks"]["root_err"]["value"] > 10 * LIMITS["root_err"]
