"""Gamma4 at the orders the JAX package runs beside the main path's order 4.

Orders 5 and 6 take minutes to generate, optimize and lower on the host, so
they go the artifact route: ``backends.compile.export_artifact`` here, then
``load_artifact`` -> ``make_leaf_evaluator`` + ``make_evaluator`` wherever
the card is.  ``export_orders`` generates and optimizes the order's
diagrams once, then forks one process for each artifact asked for, so that
the lowerings run side by side; each process touches no CUDA and prints its
seconds.  The artifacts are

- ``fused`` and ``bucketed``: ``export_artifact`` of the roots in that
  ``sum_mode`` (``cse=True``, slot reuse, the default schedule), as
  ``compile_evaluator`` lowers them;
- ``config5`` and ``certify8``: ``examples.config5_serving.generate``'s
  lowering for graph sharding over 4 and over 8 ranks, the first what
  ``config5_serving`` serves and the second what ``certify_sharded`` checks
  at 8 ranks.  ``generate`` builds its own roots, as it does when run
  alone.

``differing_rows`` is the check that a pass whose weight buffer holds more
than 2^31 elements computes every column as a pass of a few columns does:
the kernel's arithmetic on a column does not depend on the batch, so three
narrow windows of the same leaf values must give the full pass's rows in
those columns bit for bit.

Usage: python -m feynmandiagram_tpu_torch.benchmarks.gamma4_orders ORDER OUT_DIR
           [--artifacts fused,bucketed,config5,certify8]
Prints a line a step, and as its last line one JSON object: each
artifact's path and seconds.  Exits non-zero where any process fails.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
from typing import Dict, List, Sequence

import torch

ARTIFACTS = ("fused", "bucketed", "config5", "certify8")
# the ranks of the graph axis each sharded artifact is lowered for
SHARDED_RANKS = {"config5": 4, "certify8": 8}


def vertex4_para(order: int):
    """The Gamma4 configuration of the main path at ``order``: innerLoopNum
    ``order``, NoHartree, instant charge-charge interaction."""
    from ..frontends import ChargeCharge, Instant, NoHartree
    from ..frontends.parquet import DiagPara, Interaction, Ver4Diag
    return DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True, filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))


def vertex4_roots(order: int):
    """``(roots, para)``: the order's Gamma4 diagrams, optimized at level 1."""
    from ..computational_graph import optimize_inplace
    from ..frontends.parquet import vertex4
    para = vertex4_para(order)
    roots = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(roots, level=1)
    return roots, para


def artifact_path(out_dir: str, order: int, name: str) -> str:
    return os.path.join(out_dir, f"gamma4_o{order}_{name}.npz")


def _export_one(order: int, name: str, path: str, roots, para) -> None:
    """One artifact, in its own process; prints its seconds."""
    if name in SHARDED_RANKS:
        from ..examples.config5_serving import generate
        t0 = time.perf_counter()
        generate(order, path, n_graph=SHARDED_RANKS[name])
        print(f"gamma4 o{order} {name}: generated, optimized, lowered for "
              f"{SHARDED_RANKS[name]} graph ranks, tables and saved in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return
    from ..backends.compile import export_artifact
    secs = export_artifact(path, roots, max_loop_num=para.totalLoopNum, sum_mode=name,
                           cse=True)
    print(f"gamma4 o{order} {name}: lowered in {secs['lower_s']:.1f} s, leaf tables in "
          f"{secs['tables_s']:.3f} s, saved in {secs['save_s']:.1f} s "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MB)", flush=True)


def export_orders(order: int, out_dir: str,
                  artifacts: Sequence[str] = ARTIFACTS) -> Dict[str, str]:
    """Write the order's ``artifacts`` into ``out_dir``; return their paths.

    The roots are generated and optimized once, here; then each artifact is
    made in a forked process, all at once.  Fork shares the roots without
    pickling them; this process has touched no CUDA and started no thread.
    Raises ``RuntimeError`` where a process fails."""
    unknown = set(artifacts) - set(ARTIFACTS)
    if unknown:
        raise ValueError(f"unknown artifacts {sorted(unknown)}; known: {ARTIFACTS}")
    t0 = time.perf_counter()
    roots, para = vertex4_roots(order)
    print(f"gamma4 o{order}: {len(roots)} roots generated and optimized in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ctx = multiprocessing.get_context("fork")
    paths = {name: artifact_path(out_dir, order, name) for name in artifacts}
    procs = [(name, ctx.Process(target=_export_one, args=(order, name, path, roots, para)))
             for name, path in paths.items()]
    for _, proc in procs:
        proc.start()
    for _, proc in procs:
        proc.join()
    failed = [f"{name} (exit {proc.exitcode})" for name, proc in procs if proc.exitcode != 0]
    if failed:
        raise RuntimeError(f"gamma4 order {order}: {', '.join(failed)} failed")
    return paths


def column_windows(batch: int, width: int) -> List[slice]:
    """The first, a middle and the last ``width`` columns of ``batch``; the
    middle one starts at a multiple of ``width``."""
    if not 0 < width <= batch:
        raise ValueError(f"windows of {width} columns in a batch of {batch}")
    mid = min(batch // 2 // width * width, batch - width)
    return [slice(0, width), slice(mid, mid + width), slice(batch - width, batch)]


_SAME_SIZE_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def differing_rows(graph_fn, leaves: torch.Tensor, w: torch.Tensor,
                   width: int) -> List[int]:
    """For each of ``column_windows(batch, width)``: ``graph_fn`` on those
    columns of ``leaves`` alone, against the same columns of ``w``, its
    buffer on all of ``leaves``; the number of rows that differ in any bit.
    ``graph_fn`` is ``make_evaluator(..., return_all=True)``."""
    bits = _SAME_SIZE_INT[w.element_size()]
    out = []
    for cols in column_windows(w.shape[1], width):
        part = graph_fn(leaves[:, cols].contiguous())
        out.append(int((part.view(bits) != w[:, cols].view(bits)).any(dim=1).sum()))
        del part
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("order", type=int)
    parser.add_argument("out_dir")
    parser.add_argument("--artifacts", default=",".join(ARTIFACTS),
                        help=f"comma-separated, of {', '.join(ARTIFACTS)}")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    paths = export_orders(args.order, args.out_dir, args.artifacts.split(","))
    print(json.dumps({"order": args.order, "paths": paths,
                      "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
