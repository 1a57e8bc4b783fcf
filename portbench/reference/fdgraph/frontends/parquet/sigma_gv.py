"""GV-compatible self-energy generator (instant interactions only).

Reference: FeynmanDiagram.jl/src/frontend/parquet/sigmaGV.jl.  As in the
reference, only the Fock-type (oW == 0) sector produces diagrams; the
composite branch builds its vertex3 but does not yet attach it (the
reference leaves that branch unfinished, sigmaGV.jl:110-112).
"""
from __future__ import annotations

import warnings
from typing import List

import numpy as np

from . import (DiagPara, GreenDiag, SigmaDiag, Ver3Diag, ParquetBlocks,
               reconstruct_para, interaction_tau_num, INL, OUTL, INR, OUTR)
from ..common import Dynamic, NoBubble, NoHartree, Proper, UpDown, UpUp, vec_allclose
from ..diagram_id import SigmaId
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, get_k, ordered_partition
from .filters import is_valid_g, is_valid_sigma
from .operation import mergeby


from . import _memo

@_memo.scoped
def sigmaGV(para: DiagPara, extK=None, subdiagram: bool = False, *,
            name: str = "Σ", blocks: ParquetBlocks = ParquetBlocks()) -> List[dict]:
    """(sigmaGV.jl:20-130)."""
    from .vertex4 import vertex4
    from .vertex3 import vertex3
    from .green import green

    for inter in para.interaction:
        if Dynamic in inter.type:
            raise ValueError("Dynamic interaction is not supported for sigmaGV diagrams.")
    if NoHartree not in para.filter:
        raise ValueError("sigmaGV diagrams must have NoHartree in para.filter.")
    if para.type != SigmaDiag:
        raise ValueError(f"{para} is not for a sigma diagram")
    if para.innerLoopNum < 1:
        raise ValueError("sigma must have at least one inner loop")
    if para.innerLoopNum > 1 and NoBubble in para.filter:
        warnings.warn("Sigma with 2+ loops still contains bubble subdiagrams!")
    if extK is None:
        extK = get_k(para.totalLoopNum, 1)
    if len(extK) < para.totalLoopNum:
        raise ValueError(f"expect dim of extK >= {para.totalLoopNum}")
    extK = np.asarray(extK[:para.totalLoopNum], float)

    composite_sigma: List[dict] = []
    if not is_valid_sigma(para.filter, para.innerLoopNum, subdiagram):
        return composite_sigma

    K = np.zeros_like(extK)
    loop_idx = para.firstLoopIdx
    K[loop_idx - 1] = 1.0
    if vec_allclose(K, extK):
        raise ValueError("K and extK cannot be the same")
    legK = [extK, K, K, extK]

    def gw_to_sigma(group, oW, para_g) -> dict:
        if group["response"] not in (UpUp, UpDown):
            raise ValueError("GW->Σ only works for UpUp or UpDown")
        response, vtype = group["response"], group["type"]
        sid = SigmaId(para, vtype, k=extK, t=group["extT"])
        g = green(para_g, K, group["GT"], True,
                  name=("Gfock" if oW == 0 else "G_Σ"), blocks=blocks)
        spinfactor = 2 if response == UpUp else -1
        if oW > 0:
            spinfactor *= 0.5
        sigmadiag = Graph([g, group["diagram"]], properties=sid, operator=PROD,
                          factor=spinfactor, name=name)
        return dict(type=vtype, extT=group["extT"], diagram=sigmadiag)

    for oG, oW in ordered_partition(para.innerLoopNum - 1, 2, 0):
        idx, max_loop = find_first_loop_idx([oW, oG], loop_idx + 1)
        if max_loop > para.totalLoopNum:
            raise AssertionError(f"maxLoop = {max_loop} > {para.totalLoopNum}")
        w_first_loop, g_first_loop = idx

        idx, max_tau = find_first_tau_idx([oW, oG], [Ver3Diag, GreenDiag],
                                          para.firstTauIdx,
                                          interaction_tau_num(para.hasTau, para.interaction))
        if max_tau > para.totalTauNum:
            raise AssertionError(f"maxTau = {max_tau} > {para.totalTauNum}")
        w_first_tau, g_first_tau = idx

        para_g = reconstruct_para(para, type=GreenDiag, innerLoopNum=oG,
                                  firstLoopIdx=g_first_loop, firstTauIdx=g_first_tau)
        para_w = reconstruct_para(para, type=Ver3Diag, innerLoopNum=oW,
                                  firstLoopIdx=w_first_loop, firstTauIdx=w_first_tau)

        if not is_valid_g(para_g):
            continue
        para_w0 = reconstruct_para(
            para_w,
            filter=tuple(dict.fromkeys(list(para_w.filter) + [Proper])),
            transferLoop=tuple(np.zeros_like(K)))
        if oW == 0:  # Fock-type Σ
            ver4 = vertex4(para_w0, legK, True, channels=[])
            rows = []
            for row in ver4:
                x = row["extT"]
                rows.append(dict(row, extT=(x[INL], x[OUTR]), GT=(x[OUTL], x[INR])))
            groups = mergeby(rows, ["response", "type", "GT", "extT"], operator=SUM)
            for merged in groups:
                composite_sigma.append(gw_to_sigma(merged, oW, para_g))
        else:
            # composite Σ branch: the reference builds vertex3 here but never
            # attaches it (sigmaGV.jl:110-112); kept for parity
            vertex3(para_w, [extK - K, extK, K])

    if not composite_sigma:
        return composite_sigma
    sigmadf = mergeby(composite_sigma, ["type", "extT"], name=name,
                      getid=lambda g: SigmaId(para, g[0]["type"], k=extK, t=g[0]["extT"]))
    for row in sigmadf:
        if row["extT"][0] != para.firstTauIdx:
            raise AssertionError("all sigma should share the same in-Tidx")
    return sigmadf
