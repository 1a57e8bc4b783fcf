"""The port's scale-out layer across real processes, after
``tests/test_distributed.py``: two gloo processes, started as
subprocesses, join through ``utils.initialize_distributed`` with a
``file://`` store in the test's own directory (no port number, so parallel
test workers cannot collide).  Each child blocks ``jax`` and the JAX
package before it imports the port, and is killed if it outlives its
timeout.

- ``Mesh.mean`` and ``Mesh.all_gather`` over the two processes;
- the graph-sharded evaluator on a graph axis of 4 ranks, 2 in each
  process, against a local 4-rank mesh in one process: bit for bit in
  float64 (the same operations on the same rows; the halo's blocks only
  travel);
- the graph-sharded MC step with its graph axis over the two processes and
  a local batch axis, against the same mesh held locally: bit for bit (the
  means are gathered and added in rank order whichever process holds a
  rank);
- ``graft_entry.dryrun_multichip(4)``, the first axis of each mesh over the
  two processes.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120

_PRELUDE = """
import sys
sys.modules["jax"] = None
sys.modules["feynmandiagram_tpu"] = None
rank, store = int(sys.argv[1]), sys.argv[2]
import numpy as np
import torch
import torch.distributed as dist
from feynmandiagram_tpu_torch.utils import initialize_distributed
initialize_distributed(f"file://{store}", 2, rank, device="cpu")
assert dist.get_world_size() == 2 and dist.get_rank() == rank
from feynmandiagram_tpu_torch.parallel import Mesh, make_sample_mesh
WORLD = dist.group.WORLD
"""

_EPILOGUE = """
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "feynmandiagram_tpu") and sys.modules[m])
assert not loaded, loaded
dist.destroy_process_group()
print("proc", rank, "ok")
"""

_MEAN = """
mesh = make_sample_mesh(device="cpu")
assert mesh.shape == {"batch": 2} and list(mesh.local_ranks("batch")) == [rank]
got = mesh.mean("batch", [torch.tensor([1.0 + rank, 10.0 * rank])])
assert torch.equal(got, torch.tensor([1.5, 5.0])), got
wide = make_sample_mesh(4, device="cpu")
assert list(wide.local_ranks("batch")) == [2 * rank, 2 * rank + 1]
blocks = [torch.full((1, 3), float(r)) for r in wide.local_ranks("batch")]
assert wide.all_gather("batch", blocks)[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0]
assert wide.all_gather("batch", blocks, dim=1)[0].tolist() == [float(r // 3) for r in range(12)]
"""

_GRAPH = """
from feynmandiagram_tpu_torch.backends.compile import leafmap_of
from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
from feynmandiagram_tpu_torch.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram_tpu_torch.frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4
from feynmandiagram_tpu_torch.ops import lower
from feynmandiagram_tpu_torch.parallel import make_graph_sharded_evaluator
para = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True, filter=(NoHartree,),
                interaction=(Interaction(ChargeCharge, Instant),))
roots = [r["diagram"] for r in vertex4(para)]
optimize_inplace(roots, level=1)
lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True, reuse_slots=False)
nl = lowered.num_leaves - len(lowered.const_slots)
vals = np.random.default_rng(23).uniform(0.5, 1.5, (nl, 8))
mesh = Mesh([("graph", 4)], device="cpu", groups={"graph": WORLD})
assert list(mesh.local_ranks("graph")) == [2 * rank, 2 * rank + 1]
g = make_graph_sharded_evaluator(lowered, mesh)
multi = g(vals)
single = make_graph_sharded_evaluator(lowered, Mesh([("graph", 4)], device="cpu"))(vals)
assert multi.dtype == torch.float64 and torch.equal(multi, single), (multi - single).abs().max()
assert g.stats.local_slots < g.stats.full_slots
"""

_MC_STEP = """
from feynmandiagram_tpu_torch.backends.compile import leaf_graphs_of, leafmap_of
from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
from feynmandiagram_tpu_torch.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram_tpu_torch.frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4
from feynmandiagram_tpu_torch.ops import lower
from feynmandiagram_tpu_torch.ops.leaf_eval import leaf_tables_from_lowered
from feynmandiagram_tpu_torch.parallel import make_graph_sharded_mc_step
para = DiagPara(type=Ver4Diag, innerLoopNum=2, hasTau=True, filter=(NoHartree,),
                interaction=(Interaction(ChargeCharge, Instant),))
roots = [r["diagram"] for r in vertex4(para)]
optimize_inplace(roots, level=1)
lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True, reuse_slots=False)
tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), para.totalLoopNum)
kw = dict(beta=0.5, kF=1.919, lam=1.0)
mesh = Mesh([("graph", 2), ("batch", 2)], device="cpu", groups={"graph": WORLD})
assert list(mesh.local_ranks("graph")) == [rank]
means = make_graph_sharded_mc_step(lowered, tables, mesh, **kw)(77, 4, 2)
local = Mesh([("graph", 2), ("batch", 2)], device="cpu")
expected = make_graph_sharded_mc_step(lowered, tables, local, **kw)(77, 4, 2)
assert torch.equal(means, expected), (means - expected).abs().max()
"""


_DRYRUN = """
from feynmandiagram_tpu_torch.graft_entry import dryrun_multichip
dryrun_multichip(4, device="cpu")
"""


def _run_pair(body, tmp_path):
    """Run ``body`` in two processes of one gloo group; each must print its
    ok line within CHILD_TIMEOUT seconds, or both are killed."""
    env = dict(os.environ, PYTHONPATH=REPO)
    script = _PRELUDE + body + _EPILOGUE
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {r} failed:\n{out}"
        assert f"proc {r} ok" in out


def test_two_process_mean_and_all_gather(tmp_path):
    _run_pair(_MEAN, tmp_path)


def test_two_process_graph_sharded_evaluator(tmp_path):
    _run_pair(_GRAPH, tmp_path)


def test_two_process_graph_sharded_mc_step(tmp_path):
    _run_pair(_MC_STEP, tmp_path)


def test_two_process_dryrun_multichip(tmp_path):
    """``graft_entry.dryrun_multichip`` with the first axis of each mesh
    over the two processes."""
    _run_pair(_DRYRUN, tmp_path)


def test_initialize_distributed_without_configuration_does_nothing(monkeypatch):
    """No arguments and no MASTER_ADDR / WORLD_SIZE: nothing to join."""
    torch = pytest.importorskip("torch")
    from feynmandiagram_tpu_torch.utils import initialize_distributed
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("file:///nonexistent", 2)
