"""3-point vertex Γ3 = Γ4·G·G.

Reference: FeynmanDiagram.jl/src/frontend/parquet/vertex3.jl.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import (DiagPara, GreenDiag, Ver3Diag, Ver4Diag, ParquetBlocks,
               reconstruct_para, interaction_tau_num, INL, OUTL, INR, OUTR)
from ..common import Alli, PHr, PHEr, PPr, Proper, UpDown, UpUp
from ..diagram_id import Ver3Id
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, ordered_partition
from .filters import is_valid_g
from .operation import mergeby


from . import _memo

@_memo.scoped
def vertex3(para: DiagPara, _extK=None, subdiagram: bool = False, *,
            name: str = "Γ3", channels=(PHr, PHEr, PPr, Alli),
            blocks: ParquetBlocks = ParquetBlocks()) -> List[dict]:
    """Generate 3-vertex diagrams (vertex3.jl:20-113).

    ``_extK`` = [bosonic leg q (out), fermionic in Kin]; the fermionic out
    leg is Kin - q.  With tau, all vertex3 share extT[0] = firstTauIdx and
    extT[1] = firstTauIdx + 1.
    """
    from .vertex4 import vertex4
    from .green import green
    from .common import get_k

    if _extK is None:
        _extK = [get_k(para.totalLoopNum, 1), get_k(para.totalLoopNum, 2)]
    if para.type != Ver3Diag:
        raise ValueError("vertex3 expects a Ver3Diag para")
    if para.innerLoopNum < 1:
        raise ValueError("vertex3 requires at least one internal loop")
    for k in _extK:
        if len(k) < para.totalLoopNum:
            raise ValueError(f"expect dim of extK >= {para.totalLoopNum}")

    q = np.asarray(_extK[0][:para.totalLoopNum], float)
    Kin = np.asarray(_extK[1][:para.totalLoopNum], float)
    Kout = Kin - q
    if np.allclose(q, Kin) or np.allclose(q, Kout):
        raise ValueError("bosonic q cannot equal a fermionic leg momentum "
                         "(the proper-diagram check would fail)")
    extK = [q, Kin, Kout]

    para = _proper_ver3_para(para, q)
    t0 = para.firstTauIdx
    rows: List[dict] = []

    K = np.zeros_like(q)
    loop_idx = para.firstLoopIdx
    K[loop_idx - 1] = 1.0
    legK = [Kin, Kout, K, K + q]

    for oVer4, oGin, oGout in ordered_partition(para.innerLoopNum - 1, 3, 0):
        # Vertex4 first so its TinL starts at t0+1
        idx, max_loop = find_first_loop_idx([oVer4, oGin, oGout], loop_idx + 1)
        if max_loop > para.totalLoopNum:
            raise AssertionError(f"maxLoop = {max_loop} > {para.totalLoopNum}")
        ver4_kidx, gin_kidx, gout_kidx = idx

        ver4_t0 = t0 + 1 if para.hasTau else t0
        idx, max_tau = find_first_tau_idx([oVer4, oGin, oGout],
                                          [Ver4Diag, GreenDiag, GreenDiag], ver4_t0,
                                          interaction_tau_num(para.hasTau, para.interaction))
        if max_tau > para.totalTauNum:
            raise AssertionError(f"maxTau = {max_tau} > {para.totalTauNum}")
        ver4_tidx, gin_tidx, gout_tidx = idx

        if not (is_valid_g(para.filter, oGin) and is_valid_g(para.filter, oGout)):
            continue
        para_gin = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGin,
                                    firstLoopIdx=gin_kidx, firstTauIdx=gin_tidx)
        para_gout = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGout,
                                     firstLoopIdx=gout_kidx, firstTauIdx=gout_tidx)
        para_ver4 = reconstruct_para(para, type=Ver4Diag, innerLoopNum=oVer4,
                                     firstLoopIdx=ver4_kidx, firstTauIdx=ver4_tidx)
        ver4 = vertex4(para_ver4, legK, True, channels=channels, blocks=blocks)
        if not ver4:
            continue
        if para.hasTau:
            for row in ver4:
                if row["extT"][INL] != ver4_t0:
                    raise AssertionError("TinL of the inner Γ4 must be firstTauIdx+1")

        v4rows = []
        for row in ver4:
            x = row["extT"]
            v4rows.append(dict(row, extT=(t0, x[INL], x[OUTL]),
                               GinT=(t0, x[INR]), GoutT=(x[OUTR], t0)))
        groups = mergeby(v4rows, ["response", "GinT", "GoutT", "extT"], operator=SUM)

        for v4 in groups:
            response = v4["response"]
            if response not in (UpUp, UpDown):
                raise AssertionError("vertex4 response must be UpUp or UpDown")
            ver3id = Ver3Id(para, response, k=extK, t=v4["extT"])
            gin = green(para_gin, K, v4["GinT"], True, name="Gin", blocks=blocks)
            gout = green(para_gout, K + q, v4["GoutT"], True, name="Gout", blocks=blocks)
            if not isinstance(gin, Graph) or not isinstance(gout, Graph):
                raise AssertionError("green must return a Graph")
            ver3diag = Graph([gin, gout, v4["diagram"]], properties=ver3id,
                             operator=PROD, name=name)
            rows.append(dict(response=response, extT=v4["extT"], diagram=ver3diag))

    if rows:
        rows = mergeby(rows, ["response", "extT"], name=name,
                       getid=lambda g: Ver3Id(para, g[0]["response"], k=extK,
                                              t=g[0]["extT"]))
    return rows


def _proper_ver3_para(p: DiagPara, q) -> DiagPara:
    """Reset transferLoop to q when Proper filtering (vertex3.jl:115-123)."""
    if Proper in p.filter:
        if len(p.transferLoop) != len(q) or not np.allclose(p.transferLoop, q):
            return reconstruct_para(p, transferLoop=tuple(q))
    return p
