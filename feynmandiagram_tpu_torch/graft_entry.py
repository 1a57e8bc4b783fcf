"""Entry points of the port: the single-card step and the multi-chip dry run.

Counterpart of the repository's ``__graft_entry__.py``, on the port's own
pipeline and its ``parallel`` layer:

- ``entry(device=None)`` returns ``(fn, (varK, varT))``: the fused order-4
  Gamma4 step (leaf phase, LoopPool product, the level launches) and
  seeded example samples, on the card unless ``device`` says otherwise;
- ``dryrun_multichip(n_devices, device=None)`` runs the JAX package's
  multi-chip paths on meshes of ``n_devices`` ranks and checks each against
  the unsharded evaluator: the sample axis (``make_sample_mesh``,
  ``make_mc_step``, ``shard_compiled``), the graph axis and the 2-D graph x
  batch mesh (``make_graph_sharded_evaluator`` on order-3 Gamma4), and the
  config-5 serving step (``examples.config5_serving.serve``, the 4 x 2
  mesh).  Each mesh is local to this process unless ``torch.distributed``
  is initialised, and then its first axis spans the default group.  The
  JAX package's order-5 runs of the same paths take minutes of host
  generation; ``examples.config5_serving`` runs them at its default order 5.

Usage: python -m feynmandiagram_tpu_torch.graft_entry [n_devices] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

BETA, KF, LAM = 0.5, 1.919, 1.0


def _build_compiled(order: int, *, optimize_level: int = 1, device=None, dtype=None):
    """``(compiled, para)``: order-``order`` Gamma4, optimized at
    ``optimize_level`` and compiled fused on ``device``."""
    from .backends.compile import compile_evaluator
    from .computational_graph import optimize_inplace
    from .frontends import ChargeCharge, Instant, NoHartree
    from .frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4

    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True, filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(roots, level=optimize_level)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                 lam=LAM, device=device, dtype=dtype)
    return compiled, para


def entry(device=None):
    """``(fn, example_args)``: the fused order-4 vertex-4 evaluation step."""
    compiled, para = _build_compiled(4, device=device)
    batch = 256
    rng = np.random.default_rng(0)
    varK = rng.standard_normal((3, para.totalLoopNum, batch))
    varT = rng.random((para.totalLoopNum, batch)) * BETA
    return compiled.fn, (varK, varT)


def _check(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"{what}: differs from the unsharded evaluator")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the multi-chip paths on ``n_devices`` ranks (even, >= 2) and
    raise ``AssertionError`` where one differs from the unsharded
    evaluator (rtol 1e-4, atol 1e-5, the JAX dry run's bounds)."""
    from .backends.compile import leaf_graphs_of, leafmap_of
    from .computational_graph import optimize_inplace
    from .examples import config5_serving
    from .frontends import ChargeCharge, Instant, NoHartree
    from .frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4
    from .ops import lower, make_evaluator
    from .ops.leaf_eval import leaf_tables_from_lowered, make_leaf_evaluator
    from .parallel import (GRAPH_AXIS, Mesh, make_graph_sharded_evaluator, make_mc_step,
                           make_sample_mesh, rank_seed, shard_compiled)

    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"n_devices {n_devices}: the 2-D mesh needs an even count >= 2")
    world = {GRAPH_AXIS: dist.group.WORLD} if dist.is_initialized() else None

    # 1. the sample axis: the MC step and the sharded pipeline, order-2 Gamma4
    compiled, para = _build_compiled(2, optimize_level=0, device=device)
    mesh = make_sample_mesh(n_devices, device=device)
    means = make_mc_step(compiled, mesh, beta=BETA)(0, 8)
    if not torch.isfinite(means).all():
        raise AssertionError("sample-axis MC step: means not finite")
    batch = 8 * n_devices
    rng = np.random.default_rng(1)
    varK = rng.standard_normal((3, para.totalLoopNum, batch))
    varT = rng.random((para.totalLoopNum, batch)) * BETA
    _check(shard_compiled(compiled, mesh)(varK, varT), compiled(varK, varT),
           "sample-axis shard_compiled")

    # 2. the graph axis and the 2-D graph x batch mesh, order-3 Gamma4 fused
    para3 = DiagPara(type=Ver4Diag, innerLoopNum=3, hasTau=True, filter=(NoHartree,),
                     interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para3)]
    optimize_inplace(roots, level=1)
    lowered = lower(roots, leafmap_of(roots), sum_mode="fused", cse=True, reuse_slots=False)
    nl = lowered.num_leaves - len(lowered.const_slots)
    vals = np.random.default_rng(2).uniform(0.5, 1.5, (nl, 2 * n_devices))
    single = make_evaluator(lowered, device=device)
    sharded = make_graph_sharded_evaluator(
        lowered, Mesh([(GRAPH_AXIS, n_devices)], device=device, groups=world))
    _check(sharded(vals), single(vals), "graph-sharded evaluator")
    if not sharded.stats.local_slots < sharded.stats.full_slots:
        raise AssertionError("graph sharding must shrink the buffer a rank holds")
    mesh2d = Mesh([(GRAPH_AXIS, n_devices // 2), ("batch", 2)], device=device, groups=world)
    _check(make_graph_sharded_evaluator(lowered, mesh2d, batch_axis="batch")(vals),
           single(vals), "graph x batch evaluator")

    # 3. the config-5 serving step on its 4 x 2 mesh, against the unsharded
    # estimator on the same draws (rank_seed(seed, batch rank, iteration))
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), para3.totalLoopNum)
    bpd, iters, seed = 4, 2, 5
    got, _, mesh5 = config5_serving.serve(lowered, tables, device=device,
                                          batch_per_device=bpd, iters=iters, seed=seed)
    leaf_fn = make_leaf_evaluator(tables, beta=BETA, kF=KF, lam=LAM, device=mesh5.device,
                                  dtype=got.dtype)
    ev = make_evaluator(lowered, device=mesh5.device, dtype=got.dtype)
    num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
    acc = torch.zeros_like(got)
    for b in range(mesh5.shape["batch"]):
        for i in range(iters):
            gen = torch.Generator(device=mesh5.device)
            gen.manual_seed(rank_seed(seed, b, i))
            vk = torch.randn((3, para3.totalLoopNum, bpd), generator=gen, dtype=got.dtype,
                             device=mesh5.device)
            vt = torch.rand((num_tau, bpd), generator=gen, dtype=got.dtype,
                            device=mesh5.device) * BETA
            acc += ev(leaf_fn(vk, vt)).sum(dim=1)
    _check(got, acc / (mesh5.shape["batch"] * iters * bpd), "config-5 serving step")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    fn, example = entry(device=args.device)
    print("entry ok:", tuple(fn(*example).shape))
    dryrun_multichip(args.n_devices, device=args.device)
    print("dryrun ok")


if __name__ == "__main__":
    main()
