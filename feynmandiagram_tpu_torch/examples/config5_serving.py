"""BASELINE config-5 workflow: generate once, serve sharded.

Port of ``examples/config5_serving.py``.

Job 1 (generation, any host): build the order-N vertex-4 graph via Parquet,
optimize, lower with single-assignment slots under the schedule that suits
the graph axis best (``parallel.lower_sharded_best``), and export one
``.npz`` artifact.

Job 2 (serving): load the artifact (no Parquet, no symbolic graphs) and run
the Monte-Carlo estimation step with the graph memory-partitioned over the
``graph`` axis and samples data-parallel over the ``batch`` axis
(``parallel.make_graph_sharded_mc_step``).  The mesh is 4 x 2 (graph x
batch), local to this process on its one device, unless
``torch.distributed`` is initialised: then the graph axis spans the
processes of the default group.  The JAX step runs its iterations under one
``jax.jit``; ``--jit`` (``serve(jit=True)``) replays one captured CUDA graph
an iteration (``make_graph_sharded_mc_step(jit=True)``), and raises
``ValueError`` off CUDA.

Usage:  python -m feynmandiagram_tpu_torch.examples.config5_serving [order] [artifact.npz]
            [--device cpu] [--batch-per-device N] [--iters N] [--jit]
"""
import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from feynmandiagram_tpu_torch.ops.dtypes import default_device
from feynmandiagram_tpu_torch.parallel import GRAPH_AXIS, Mesh, make_graph_sharded_mc_step

MESH = (("graph", 4), ("batch", 2))
BETA, KF, LAM = 0.5, 1.919, 1.0


def generate(order: int, path: str, n_graph: int = 4) -> None:
    from feynmandiagram_tpu_torch.backends.compile import (leaf_graphs_of, leafmap_of,
                                                           save_lowered)
    from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
    from feynmandiagram_tpu_torch.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram_tpu_torch.frontends.parquet import (DiagPara, Interaction, Ver4Diag,
                                                            vertex4)
    from feynmandiagram_tpu_torch.ops.leaf_eval import leaf_tables_from_lowered
    from feynmandiagram_tpu_torch.parallel import lower_sharded_best

    t0 = time.perf_counter()
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True, filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(roots, level=1)
    lowered, sched = lower_sharded_best(roots, leafmap_of(roots), n_graph, cse=True)
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), para.totalLoopNum)
    save_lowered(path, lowered, tables)
    print(f"[generate] order {order}: {len(roots)} roots (schedule={sched}) -> {path} "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MB) in {time.perf_counter() - t0:.1f} s")


def serve(lowered, tables, *, device=None, batch_per_device: int = 8, iters: int = 4,
          seed: int = 0, jit: bool = False):
    """One sharded estimation step of ``lowered`` (with its leaf tables) on
    the 4 x 2 mesh, its graph axis over the default process group where
    ``torch.distributed`` is initialised: prints the footprint and the first
    means, and returns ``(means, step, mesh)``.  ``jit``: the step's
    iteration captured as one CUDA graph."""
    device = torch.device(device) if device is not None else default_device()
    groups = {GRAPH_AXIS: dist.group.WORLD} if dist.is_initialized() else None
    mesh = Mesh(MESH, device=device, groups=groups)
    step = make_graph_sharded_mc_step(lowered, tables, mesh, beta=BETA, kF=KF, lam=LAM, jit=jit)
    st = step.stats
    print(f"[serve] {lowered.num_slots} slots -> {st.local_slots}/rank on a {mesh.shape} "
          f"mesh on {device}; halo {st.halo_bytes_per_sample() / 1024:.1f} KiB/sample "
          f"(pad {st.halo_pad_overhead:.3f}, early {st.early_share:.2f})")
    t0 = time.perf_counter()
    means = step(seed, batch_per_device, iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = batch_per_device * iters * mesh.shape["batch"]
    print(f"[serve] {n} samples in {dt:.2f} s (the first call; builds the kernel where it "
          f"is not built{', and captures the iteration' if jit else ''}); first root means: "
          f"{means[:4].cpu().numpy()}")
    return means, step, mesh


def main(argv=None):
    from feynmandiagram_tpu_torch.backends.compile import load_artifact

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # default = order 5, the near-named config-5 scale; order 6 runs the
    # same path.  On the host (chip_smoke.py's `gamma4 host:` lines, one core
    # a process beside other work) order 5 generates and optimizes in ~19 s
    # and lowers in 11-16 s a mode; order 6 in ~94 s and 77-96 s
    parser.add_argument("order", nargs="?", type=int, default=5)
    parser.add_argument("artifact", nargs="?", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    parser.add_argument("--batch-per-device", type=int, default=8)
    parser.add_argument("--iters", type=int, default=4)
    parser.add_argument("--jit", action="store_true",
                        help="capture the step's iteration as a CUDA graph (a CUDA device)")
    args = parser.parse_args(argv)
    path = args.artifact or os.path.join(tempfile.gettempdir(), f"ver4_o{args.order}.npz")
    if not os.path.exists(path):
        generate(args.order, path)
    lowered, tables = load_artifact(path)
    serve(lowered, tables, device=args.device, batch_per_device=args.batch_per_device,
          iters=args.iters, jit=args.jit)


if __name__ == "__main__":
    main()
