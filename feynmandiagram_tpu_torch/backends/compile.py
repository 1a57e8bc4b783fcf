"""Back end: compile optimized graphs into one batched PyTorch pipeline.

Port of ``feynmandiagram_tpu/backends/compile.py``: ``compile_evaluator``
lowers the roots and chains the leaf phase (LoopPool product, G and V
physics) with the graph phase (level-by-level evaluation, buckets through
the CUDA kernel) over a batch of Monte-Carlo samples.  PyTorch runs
eagerly, so there is no ``jit``; the reference's TPU ``layout`` is gone.

The artifact functions read and write the JAX package's ``.npz`` format
(``ARTIFACT_VERSION = 2``), so a graph generated and lowered by either
package evaluates in the other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..computational_graph import Graph
from ..ops.lowering import (FusedBucket, LevelPlan, LoweredGraph, PowerPlan,
                            ProdPlan, SumBucket, SumPlan, lower)
from ..ops.dtypes import default_device, default_dtype
from ..ops.evaluator import make_evaluator
from ..ops.leaf_eval import LeafTables, leaf_tables_from_lowered, make_leaf_evaluator


def leafmap_of(roots: Sequence[Graph]) -> Dict[int, int]:
    """Assign 0-based leaf-value indices in first-visit order, as the
    reference Compilers.compile leafMap does (static.jl:115-120)."""
    leafmap: Dict[int, int] = {}
    for g in roots:
        for leaf in g.leaves():
            if leaf.operator.kind == "unitary":
                continue
            if leaf.id not in leafmap:
                leafmap[leaf.id] = len(leafmap)
    return leafmap


def leaf_graphs_of(roots: Sequence[Graph]) -> Dict[int, Graph]:
    out: Dict[int, Graph] = {}
    for g in roots:
        for leaf in g.leaves():
            out.setdefault(leaf.id, leaf)
    return out


@dataclass
class CompiledEvaluator:
    """The whole pipeline: (varK, varT) -> root weights [R, batch]."""
    lowered: LoweredGraph
    tables: LeafTables
    fn: Callable
    leaf_fn: Callable
    graph_fn: Callable
    max_loop_num: int

    def __call__(self, varK, varT) -> torch.Tensor:
        return self.fn(varK, varT)


def compile_evaluator(roots: Sequence[Graph], *, max_loop_num: int,
                      beta: float, kF: float, lam: float, device=None, dtype=None,
                      interaction_convention: str = "lambda_power",
                      sum_mode: str = "fused", merge_threshold: int = 0,
                      acc_dtype=None, cse: bool = True,
                      compensated: bool = False,
                      chunk_rows: Optional[int] = None) -> CompiledEvaluator:
    """Lower ``roots`` and build the batched evaluator on ``device``.

    - ``varK``: [dim, max_loop_num, batch] loop-momentum samples
    - ``varT``: [num_tau, batch] imaginary-time samples (1-based tau indices
      in the graph ids index into rows of varT)
    - ``dtype``: default float32 on CUDA, float64 on the CPU
    - ``sum_mode``: lowering strategy (see ``ops.lowering.lower``)
    - ``acc_dtype``: widened accumulation dtype of the graph phase
    """
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    leafmap = leafmap_of(roots)
    lowered = lower(roots, leafmap, sum_mode=sum_mode,
                    merge_threshold=merge_threshold, cse=cse)
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), max_loop_num)
    leaf_fn = make_leaf_evaluator(tables, beta=beta, kF=kF, lam=lam, device=device,
                                  dtype=dtype,
                                  interaction_convention=interaction_convention)
    graph_fn = make_evaluator(lowered, device=device, dtype=dtype,
                              acc_dtype=acc_dtype, compensated=compensated,
                              chunk_rows=chunk_rows)

    def fn(varK, varT) -> torch.Tensor:
        return graph_fn(leaf_fn(varK, varT))

    return CompiledEvaluator(lowered, tables, fn, leaf_fn, graph_fn, max_loop_num)


# ---------------------------------------------------------------------------
# artifacts: the serialized flat IR plus leaf tables, so that generation and
# evaluation can run in different jobs (and in different packages)
# ---------------------------------------------------------------------------

ARTIFACT_VERSION = 2


def save_lowered(path: str, lowered: LoweredGraph,
                 tables: Optional[LeafTables] = None) -> None:
    """Serialize a LoweredGraph (any sum_mode: csr, bucketed, or fused) and
    optional LeafTables to one .npz artifact."""
    uids = np.asarray(sorted(lowered.leaf_uid_to_slot), np.int64)
    payload = {
        "version": np.int64(ARTIFACT_VERSION),
        "num_slots": lowered.num_slots,
        "num_leaves": lowered.num_leaves,
        "num_edges": lowered.num_edges,
        "root_slots": lowered.root_slots,
        "const_slots": lowered.const_slots,
        "const_values": lowered.const_values,
        "num_levels": len(lowered.levels),
        "leaf_uids": uids,
        "leaf_uid_slots": np.asarray(
            [lowered.leaf_uid_to_slot[u] for u in uids], np.int64),
    }
    if tables is not None:
        payload.update({
            "leaf_type": tables.leaf_type,
            "g_order": tables.g_order,
            "v_order": tables.v_order,
            "tau_in": tables.tau_in,
            "tau_out": tables.tau_out,
            "loop_idx": tables.loop_idx,
            "loop_basis": tables.loop_basis,
        })
    for i, level in enumerate(lowered.levels):
        if level.sums is not None:
            s = level.sums
            payload[f"lev{i}_sum"] = np.asarray([s.start, s.count])
            payload[f"lev{i}_sum_src"] = s.edge_src
            payload[f"lev{i}_sum_fac"] = s.edge_factor
            payload[f"lev{i}_sum_seg"] = s.edge_seg
        for j, sb in enumerate(level.sum_buckets):
            payload[f"lev{i}_sb{j}"] = np.asarray([sb.arity, sb.start, sb.count])
            payload[f"lev{i}_sb{j}_idx"] = sb.idx
            payload[f"lev{i}_sb{j}_fac"] = sb.fac
        for j, fb in enumerate(level.fused):
            payload[f"lev{i}_fb{j}"] = np.asarray(
                [fb.arity, fb.n_op, fb.start, fb.count])
            payload[f"lev{i}_fb{j}_idx"] = fb.idx
            payload[f"lev{i}_fb{j}_fac"] = fb.fac
        for j, p in enumerate(level.prods):
            payload[f"lev{i}_prod{j}"] = np.asarray([p.arity, p.start, p.count])
            payload[f"lev{i}_prod{j}_idx"] = p.idx
            payload[f"lev{i}_prod{j}_fac"] = p.factor
        for j, pw in enumerate(level.pows):
            payload[f"lev{i}_pow{j}"] = np.asarray([pw.n, pw.start, pw.count])
            payload[f"lev{i}_pow{j}_src"] = pw.src
            payload[f"lev{i}_pow{j}_fac"] = pw.factor
    np.savez_compressed(path, **payload)


def export_artifact(path: str, roots: Sequence[Graph], *, max_loop_num: int,
                    sum_mode: str = "fused", **lower_kwargs) -> Dict[str, float]:
    """Lower ``roots`` (fused mode by default) and serialize the flat IR and
    leaf tables to one .npz artifact.  Returns the seconds that each step
    took: ``lower_s``, ``tables_s`` and ``save_s``."""
    t0 = time.perf_counter()
    lowered = lower(roots, leafmap_of(roots), sum_mode=sum_mode, **lower_kwargs)
    t1 = time.perf_counter()
    tables = leaf_tables_from_lowered(lowered, leaf_graphs_of(roots), max_loop_num)
    t2 = time.perf_counter()
    save_lowered(path, lowered, tables)
    return {"lower_s": t1 - t0, "tables_s": t2 - t1, "save_s": time.perf_counter() - t2}


def load_artifact(path: str):
    """Load an artifact back into (LoweredGraph, LeafTables or None): enough
    to build ``make_evaluator(lowered)`` and ``make_leaf_evaluator(tables,
    ...)`` with no access to the symbolic graphs."""
    z = np.load(path)
    version = int(z["version"]) if "version" in z else 1
    if version > ARTIFACT_VERSION:
        raise ValueError(f"artifact version {version} is newer than supported "
                         f"({ARTIFACT_VERSION})")

    def plans(i: int, tag: str, make):
        out, j = [], 0
        while f"lev{i}_{tag}{j}" in z:
            out.append(make(f"lev{i}_{tag}{j}"))
            j += 1
        return out

    levels = []
    for i in range(int(z["num_levels"])):
        sums = None
        if f"lev{i}_sum" in z:
            start, count = z[f"lev{i}_sum"]
            sums = SumPlan(int(start), int(count), z[f"lev{i}_sum_src"],
                           z[f"lev{i}_sum_fac"], z[f"lev{i}_sum_seg"])
        sum_buckets = plans(i, "sb", lambda k: SumBucket(
            *map(int, z[k]), z[f"{k}_idx"], z[f"{k}_fac"]))
        fused = plans(i, "fb", lambda k: FusedBucket(
            *map(int, z[k]), z[f"{k}_idx"], z[f"{k}_fac"]))
        prods = plans(i, "prod", lambda k: ProdPlan(
            *map(int, z[k]), z[f"{k}_idx"], z[f"{k}_fac"]))
        pows = plans(i, "pow", lambda k: PowerPlan(
            *map(int, z[k]), z[f"{k}_src"], z[f"{k}_fac"]))
        levels.append(LevelPlan(sums, prods, pows, sum_buckets, fused))
    leaf_uid_to_slot = {}
    if "leaf_uids" in z:
        leaf_uid_to_slot = {int(u): int(s) for u, s in
                            zip(z["leaf_uids"], z["leaf_uid_slots"])}
    lowered = LoweredGraph(
        num_slots=int(z["num_slots"]), num_leaves=int(z["num_leaves"]),
        levels=levels, root_slots=z["root_slots"],
        leaf_uid_to_slot=leaf_uid_to_slot,
        const_slots=z["const_slots"], const_values=z["const_values"],
        num_edges=int(z["num_edges"]) if "num_edges" in z else 0)
    tables = None
    if "leaf_type" in z:
        tables = LeafTables(z["leaf_type"], z["g_order"], z["v_order"],
                            z["tau_in"], z["tau_out"], z["loop_idx"],
                            z["loop_basis"])
    return lowered, tables
