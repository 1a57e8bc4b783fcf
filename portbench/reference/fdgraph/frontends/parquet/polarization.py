"""Polarization Π = G·G·Γ3 (with Π0 = ∓G·G).

Reference: FeynmanDiagram.jl/src/frontend/parquet/polarization.jl.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import (DiagPara, GreenDiag, PolarDiag, Ver3Diag, ParquetBlocks,
               reconstruct_para, interaction_tau_num)
from ..common import Proper, UpDown, UpUp, vec_allclose
from ..diagram_id import PolarId
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, ordered_partition
from .filters import is_valid_g
from .operation import mergeby


from . import _memo

@_memo.scoped
def polarization(para: DiagPara, extK=None, subdiagram: bool = False, *,
                 name: str = "Π", blocks: ParquetBlocks = ParquetBlocks()) -> List[dict]:
    """Generate polarization diagrams (polarization.jl:18-128).

    All polarization graphs share extT = (firstTauIdx, firstTauIdx+1).
    """
    from .vertex3 import vertex3
    from .green import green
    from .common import get_k

    if extK is None:
        extK = get_k(para.totalLoopNum, 1)
    if para.type != PolarDiag:
        raise ValueError("polarization expects a PolarDiag para")
    if para.innerLoopNum < 1:
        raise ValueError("polarization requires at least one internal loop")
    if len(extK) < para.totalLoopNum:
        raise ValueError(f"expect dim of extK >= {para.totalLoopNum}")

    para = _proper_polar_para(para, np.asarray(extK[:para.totalLoopNum], float))
    extK = np.asarray(extK[:para.totalLoopNum], float)

    K = np.zeros_like(extK)
    loop_idx = para.firstLoopIdx
    K[loop_idx - 1] = 1.0
    if vec_allclose(K, extK):
        raise ValueError("K and extK cannot be the same")
    t0 = para.firstTauIdx
    extT = (t0, t0 + 1) if para.hasTau else (t0, t0)
    legK = [extK, K, K - extK]

    rows: List[dict] = []
    for oVer3, oGin, oGout in ordered_partition(para.innerLoopNum - 1, 3, 0):
        # Vertex3 first so its bosonic extT starts at t0+1
        idx, max_loop = find_first_loop_idx([oVer3, oGin, oGout], loop_idx + 1)
        if max_loop > para.totalLoopNum:
            raise AssertionError(f"maxLoop = {max_loop} > {para.totalLoopNum}")
        ver3_kidx, gin_kidx, gout_kidx = idx

        if not (is_valid_g(para.filter, oGin) and is_valid_g(para.filter, oGout)):
            continue

        if oVer3 == 0:
            # Π0 = GG
            gt0 = extT[1] + 1 if para.hasTau else extT[0]
            idx, max_tau = find_first_tau_idx([oGin, oGout], [GreenDiag, GreenDiag],
                                              gt0, interaction_tau_num(para.hasTau, para.interaction))
            if max_tau > para.totalTauNum:
                raise AssertionError(f"maxTau = {max_tau} > {para.totalTauNum}")
            gin_tidx, gout_tidx = idx

            para_gin = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGin,
                                        firstLoopIdx=gin_kidx, firstTauIdx=gin_tidx)
            para_gout = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGout,
                                         firstLoopIdx=gout_kidx, firstTauIdx=gout_tidx)
            response = UpUp
            polarid = PolarId(para, response, k=extK, t=extT)
            gin = green(para_gin, K, (extT[0], extT[1]), True, name="Gin")
            gout = green(para_gout, K - extK, (extT[1], extT[0]), True, name="Gout")
            if not isinstance(gin, Graph) or not isinstance(gout, Graph):
                raise AssertionError("green must return a Graph")
            sign = -1.0 if para.isFermi else 1.0
            polardiag = Graph([gin, gout], properties=polarid, operator=PROD,
                              name=name, factor=sign)
            rows.append(dict(response=response, extT=extT, diagram=polardiag))
        else:
            # composite polarization
            idx, max_tau = find_first_tau_idx([oVer3, oGin, oGout],
                                              [Ver3Diag, GreenDiag, GreenDiag], extT[1],
                                              interaction_tau_num(para.hasTau, para.interaction))
            if max_tau > para.totalTauNum:
                raise AssertionError(f"maxTau = {max_tau} > {para.totalTauNum}")
            ver3_tidx, gin_tidx, gout_tidx = idx

            para_gin = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGin,
                                        firstLoopIdx=gin_kidx, firstTauIdx=gin_tidx)
            para_gout = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGout,
                                         firstLoopIdx=gout_kidx, firstTauIdx=gout_tidx)
            para_ver3 = reconstruct_para(para, type=Ver3Diag, innerLoopNum=oVer3,
                                         firstLoopIdx=ver3_kidx, firstTauIdx=ver3_tidx)
            ver3 = vertex3(para_ver3, legK, True, blocks=blocks)
            if not ver3:
                continue
            if para.hasTau:
                for row in ver3:
                    if row["extT"][0] != extT[1]:
                        raise AssertionError("the bosonic T must be firstTauIdx+1")
                    if row["extT"][1] != ver3[0]["extT"][1]:
                        raise AssertionError("the TinL must be firstTauIdx+2")

            v3rows = []
            for row in ver3:
                x = row["extT"]
                v3rows.append(dict(row, extT=extT, GinT=(extT[0], x[1]),
                                   GoutT=(x[2], extT[0])))
            groups = mergeby(v3rows, ["response", "GinT", "GoutT", "extT"], operator=SUM)

            for v3 in groups:
                response = v3["response"]
                if response not in (UpUp, UpDown):
                    raise AssertionError("vertex3 response must be UpUp or UpDown")
                polarid = PolarId(para, response, k=extK, t=v3["extT"])
                gin = green(para_gin, K, v3["GinT"], True, name="Gin", blocks=blocks)
                gout = green(para_gout, K - extK, v3["GoutT"], True, name="Gout",
                             blocks=blocks)
                if not isinstance(gin, Graph) or not isinstance(gout, Graph):
                    raise AssertionError("green must return a Graph")
                polardiag = Graph([gin, gout, v3["diagram"]], properties=polarid,
                                  operator=PROD, name=name)
                rows.append(dict(response=response, extT=v3["extT"], diagram=polardiag))

    if rows:
        rows = mergeby(rows, ["response", "extT"], name=name,
                       getid=lambda g: PolarId(para, g[0]["response"], k=extK, t=extT))
    return rows


def _proper_polar_para(p: DiagPara, q) -> DiagPara:
    """Polarization is always proper along its own extK (polarization.jl:130-136).

    Matches the reference condition verbatim: reconstruct unless the para is
    already Proper with a same-length transferLoop differing from q.
    """
    if (Proper not in p.filter) or len(p.transferLoop) != len(q) \
            or np.allclose(p.transferLoop, q):
        new_filter = tuple(dict.fromkeys(list(p.filter) + [Proper]))
        return reconstruct_para(p, transferLoop=tuple(q), filter=new_filter)
    return p
