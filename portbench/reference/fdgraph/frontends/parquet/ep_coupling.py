"""Electron-phonon 4-vertex: Γ3-like coupling with a right-aligned bare vertex.

Reference: FeynmanDiagram.jl/src/frontend/parquet/ep_coupling.jl.  NOTE: the
reference's ep_bubble! calls a bubble2diag! overload (with g0/gx pushed to
the DataFrame) that does not exist in vertex4.jl — the module is dormant and
unexercised by its test suite.  Here the loop-/tau-slot bookkeeping is kept
verbatim and the pair accumulation reuses the working ver8 machinery of
vertex4.bubble, producing Γi x G0 x Gx x bare-vertex diagrams with PHr
recoupling.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np

from . import (DiagPara, Di, GreenDiag, ParquetBlocks, Ver4Diag,
               reconstruct_para, interaction_tau_num)
from ..common import (Alli, DirectOnly, Girreducible, NoBubble, PHr, PHEr, PPr,
                      TwoBodyChannel)
from ..diagram_id import GenericId, Ver4Id
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, get_k, ordered_partition
from .filters import is_valid_g
from .operation import mergeby
from .vertex4 import (bare_ver4, bubble2diag, leg_basis, max_ver4_loop_idx,
                      max_ver4_tau_idx, merge_vertex4, tau_basis, vertex4)


from . import _memo

@_memo.scoped
def ep_coupling(para: DiagPara, *, extK=None,
                channels=(PHr, PHEr, PPr, Alli), subdiagram: bool = False,
                name: str = "none", blocks: ParquetBlocks = ParquetBlocks()) -> List[dict]:
    """Generate electron-phonon 4-vertex diagrams (ep_coupling.jl:30-84).

    The right incoming Tau is right-aligned to the last Tau for all diagrams.
    """
    warnings.warn("ep vertex4 breaks SU(2) spin symmetry!")
    if NoBubble in para.filter:
        warnings.warn("RPA chain counterterms for the outgoing interaction leg "
                      "of the ep vertex4 are not implemented!")
    if extK is None:
        extK = [get_k(para.totalLoopNum, 1), get_k(para.totalLoopNum, 2),
                get_k(para.totalLoopNum, 3)]
    for k in extK:
        if len(k) < para.totalLoopNum:
            raise ValueError(f"expect dim of extK >= {para.totalLoopNum}")
    legK = [np.asarray(k[:para.totalLoopNum], float) for k in extK[:3]]
    legK.append(legK[0] + legK[2] - legK[1])

    if para.totalTauNum < max_ver4_tau_idx(para):
        raise ValueError(f"Increase totalTauNum! {para}")
    if para.totalLoopNum < max_ver4_loop_idx(para):
        raise ValueError(f"Increase totalLoopNum! {para}")

    ver4df: List[dict] = []
    for p in ordered_partition(para.innerLoopNum - 1, 4, 0):
        if p[2] == 0:  # oR == 0: right vertex is bare
            ep_bubble(ver4df, para, legK, list(channels), p, name, blocks, 1.0)

    if NoBubble in para.filter:
        ep_rpa_chain(ver4df, para, legK, name, -1.0)

    for row in ver4df:
        if not isinstance(row["diagram"].properties, Ver4Id):
            raise AssertionError("not all ids are Ver4Id")
    ver4df = merge_vertex4(para, ver4df, name, legK)
    for row in ver4df:
        if row["extT"][0] != para.firstTauIdx:
            raise AssertionError("not all extT[0] equal the first Tau index")
    return ver4df


def ep_bubble(ver4df: List[dict], para: DiagPara, legK, chans, partition,
              name: str, blocks: ParquetBlocks, extrafactor: float = 1.0) -> None:
    """(ep_coupling.jl:86-136)."""
    from .green import green

    if partition[2] != 0:
        raise AssertionError("right sub-vertex of the ep bubble must be bare")
    tau_num = interaction_tau_num(para.hasTau, para.interaction)
    oL, oG0, oR, oGx = partition
    if not is_valid_g(para.filter, oG0) or not is_valid_g(para.filter, oGx):
        return

    loop_idx = para.firstLoopIdx
    idx, max_loop = find_first_loop_idx(partition, loop_idx + 1)
    l_first_loop, g0_first_loop, r_first_loop, gx_first_loop = idx
    if max_loop != max_ver4_loop_idx(para):
        raise AssertionError("loop index accounting mismatch")

    types = [Ver4Diag, GreenDiag, Ver4Diag, GreenDiag]
    idx, max_tau = find_first_tau_idx(partition, types, para.firstTauIdx, tau_num)
    l_first_tau, g0_first_tau, r_first_tau, gx_first_tau = idx
    if max_tau != max_ver4_tau_idx(para):
        raise AssertionError("tau index accounting mismatch")

    l_para = reconstruct_para(para, type=Ver4Diag, innerLoopNum=oL,
                              firstLoopIdx=l_first_loop, firstTauIdx=l_first_tau)
    r_para = reconstruct_para(para, type=Ver4Diag, innerLoopNum=oR,
                              firstLoopIdx=r_first_loop, firstTauIdx=r_first_tau)
    gx_para = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGx,
                               firstLoopIdx=gx_first_loop, firstTauIdx=gx_first_tau)
    g0_para = reconstruct_para(para, type=GreenDiag, innerLoopNum=oG0,
                               firstLoopIdx=g0_first_loop, firstTauIdx=g0_first_tau)

    LLegK, K, RLegK, Kx = leg_basis(PHr, legK, loop_idx)

    Lver = vertex4(l_para, LLegK, True, channels=chans, name="Γf", blocks=blocks)
    if not Lver:
        return

    Rver: List[dict] = []
    bare_ver4(Rver, r_para, RLegK, [Di], leftalign=False)  # right-aligned tau
    Rver = merge_vertex4(r_para, Rver, "bare", RLegK)
    if not Rver:
        raise AssertionError("bare right vertex must not be empty")

    ver8: Dict[tuple, list] = {}
    for lrow in Lver:
        for rrow in Rver:
            bubble2diag(ver8, para, PHr, lrow["diagram"], rrow["diagram"], legK,
                        extrafactor)

    for key, terms in ver8.items():
        G0T, GxT, extT, v_response, vtype = key
        if not terms:
            continue
        g0 = green(g0_para, K, G0T, True, name="G0", blocks=blocks)
        gx = green(gx_para, Kx, GxT, True, name="Gx", blocks=blocks)
        vid = Ver4Id(para, v_response, vtype, k=legK, t=extT, chan=PHr)
        if len(terms) == 1:
            diag = Graph([terms[0], g0, gx], properties=vid, operator=PROD)
        else:
            inner = Graph(terms, properties=GenericId(para), operator=SUM)
            diag = Graph([inner, g0, gx], properties=vid, operator=PROD)
        ver4df.append(dict(response=v_response, type=vtype, extT=extT, diagram=diag))


def ep_rpa_chain(ver4df: List[dict], para: DiagPara, legK, name: str,
                 extrafactor: float) -> None:
    """(ep_coupling.jl:138-144)."""
    new_filter = tuple(dict.fromkeys(list(para.filter) + [Girreducible, DirectOnly]))
    para_rpa = reconstruct_para(para, filter=new_filter)
    blocks = ParquetBlocks(phi=(), ppi=(), Gamma4=(PHr,))
    ep_bubble(ver4df, para_rpa, legK, [PHr], [0, 0, para.innerLoopNum - 1, 0],
              f"{name}_ep_RPA_CT", blocks, extrafactor)
