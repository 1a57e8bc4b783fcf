"""Composite Green's function via the Dyson series G = g0·(1 + ΣG + ...).

Reference: FeynmanDiagram.jl/src/frontend/parquet/green.jl.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import (DiagPara, GreenDiag, SigmaDiag, ParquetBlocks, reconstruct_para,
               interaction_tau_num)
from ..diagram_id import BareGreenId, GenericId, GreenId
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, ordered_partition
from .filters import is_valid_g, is_valid_sigma
from .operation import mergeby, merge_graphs
from . import _memo


@_memo.scoped
def green(para: DiagPara, extK=None, extT=None, subdiagram: bool = False, *,
          name: str = "G", blocks: ParquetBlocks = ParquetBlocks()) -> Optional[Graph]:
    """Build a composite Green's function graph (green.jl:21-115).

    ``para.firstTauIdx`` is the first Tau index of the left-most self-energy
    subdiagram; ``extT = (tin, tout)``.
    """
    from .sigma import sigma as build_sigma
    from .common import get_k

    if extK is None:
        extK = get_k(para.totalLoopNum, 1)
    if extT is None:
        extT = (1, 2) if para.hasTau else (0, 0)

    if not is_valid_g(para):
        raise ValueError(f"{para} does not give a valid Green's function")
    if para.type != GreenDiag:
        raise ValueError("green expects a GreenDiag para")
    if para.innerLoopNum < 0:
        raise ValueError("innerLoopNum must be >= 0")
    if len(extT) != 2:
        raise ValueError("extT must have length 2")
    if len(extK) < para.totalLoopNum:
        raise ValueError(f"expect dim of extK >= {para.totalLoopNum}")
    extK = np.asarray(extK[:para.totalLoopNum], float)

    tin, tout = extT[0], extT[1]
    t0 = para.firstTauIdx

    # repeated subproblem? return the shared DAG node (see _memo docstring)
    cache = _memo.active()
    key = ("green", para, extK.tobytes(), tin, tout, subdiagram, name, blocks)
    if cache is not None and key in cache:
        return cache[key]

    if para.innerLoopNum == 0:
        g = Graph([], properties=BareGreenId(k=extK, t=extT), name=name)
        if cache is not None:
            cache[key] = g
        return g

    def sigma_g(group, oG, t_idx, k_idx, sigma_t_idx) -> Graph:
        para_g = reconstruct_para(para, type=GreenDiag, firstTauIdx=t_idx,
                                  firstLoopIdx=k_idx, innerLoopNum=oG)
        G = green(para_g, extK, group["GT"], True, blocks=blocks)
        if not isinstance(G, Graph):
            raise AssertionError("green must return a Graph")
        pair_t = (sigma_t_idx, group["GT"][1])
        return Graph([group["diagram"], G], properties=GenericId(para, ("t", pair_t)),
                     operator=PROD, name="ΣG")

    g0 = Graph([], properties=BareGreenId(k=extK, t=(tin, t0)), name="g0")
    sigma_g_pairs: List[Graph] = []
    for p in ordered_partition(para.innerLoopNum, 2, 0):
        o_sigma, oG = p
        if not is_valid_sigma(para.filter, o_sigma, True) or not is_valid_g(para.filter, oG):
            continue

        idx, max_tau = find_first_tau_idx(p, [SigmaDiag, GreenDiag], t0,
                                          interaction_tau_num(para.hasTau, para.interaction))
        if max_tau > para.totalTauNum:
            raise AssertionError(f"maxTau {max_tau} > {para.totalTauNum}")
        if para.hasTau:
            if t0 <= tin <= max_tau or t0 <= tout <= max_tau:
                raise AssertionError(
                    f"external T index cannot be within [{t0}, {max_tau}]")
        sigma_first_t, g_first_t = idx

        idx, max_loop = find_first_loop_idx(p, para.firstLoopIdx)
        if max_loop > para.totalLoopNum:
            raise AssertionError(f"maxLoop {max_loop} > {para.totalLoopNum}")
        sigma_first_k, g_first_k = idx

        sigma_para = reconstruct_para(para, type=SigmaDiag, firstTauIdx=sigma_first_t,
                                      firstLoopIdx=sigma_first_k, innerLoopNum=o_sigma)
        sigma_df = build_sigma(sigma_para, extK, True, name="Σ", blocks=blocks)
        for row in sigma_df:
            if row["extT"][0] != sigma_first_t:
                raise AssertionError("all sigma must share the same in-Tidx")

        # combine sigmas with the same out-Tidx into ΣG pairs
        rows = []
        for row in sigma_df:
            rows.append(dict(row, Tin=row["extT"][0], GT=(row["extT"][1], extT[1])))
        groups = mergeby(rows, ["GT"], operator=SUM)
        sigma_g_pairs.extend(
            sigma_g(g, oG, g_first_t, g_first_k, sigma_first_t) for g in groups)

    merged = merge_graphs(sigma_g_pairs, operator=SUM, name="gΣG")[0]
    composite_g = Graph([g0, merged], properties=GreenId(para, k=extK, t=extT),
                        operator=PROD, name=name)
    if cache is not None:
        cache[key] = composite_g
    return composite_g
