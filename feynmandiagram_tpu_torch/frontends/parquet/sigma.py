"""Self-energy Σ = G·(2W↑↑ − W↑↓) from parquet vertex4 blocks.

Reference: FeynmanDiagram.jl/src/frontend/parquet/sigma.jl.
"""
from __future__ import annotations

import warnings
from typing import List

import numpy as np

from . import (DiagPara, GreenDiag, SigmaDiag, Ver4Diag, ParquetBlocks,
               reconstruct_para, interaction_tau_num, INL, OUTL, INR, OUTR)
from ..common import (NoBubble, NoHartree, Proper, PHr, PHEr, PPr, Alli,
                      UpUp, UpDown, vec_allclose)
from ..diagram_id import SigmaId
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, ordered_partition
from .filters import is_valid_g, is_valid_sigma
from .operation import mergeby


from . import _memo
from ...utils.profiling import phased

@phased("sigma")
@_memo.scoped
def sigma(para: DiagPara, extK=None, subdiagram: bool = False, *,
          name: str = "Σ", blocks: ParquetBlocks = ParquetBlocks()) -> List[dict]:
    """Build self-energy diagrams (sigma.jl:20-137).

    All Σ share the same incoming Tau index but not the outgoing one.
    Returns rows {type, extT, diagram}.
    """
    from .vertex4 import vertex4
    from .green import green
    from .common import get_k

    if extK is None:
        extK = get_k(para.totalLoopNum, 1)
    if para.type != SigmaDiag:
        raise ValueError(f"{para} is not for a sigma diagram")
    if para.innerLoopNum < 1:
        raise ValueError("sigma must have at least one inner loop")
    if para.innerLoopNum > 1 and NoBubble in para.filter:
        warnings.warn("Sigma with 2+ loops still contains bubble subdiagrams "
                      "even with NoBubble in para.filter!")
    if len(extK) < para.totalLoopNum:
        raise ValueError(f"expect dim of extK >= {para.totalLoopNum}, got {len(extK)}")
    extK = np.asarray(extK[:para.totalLoopNum], float)

    # repeated subproblem? return the shared rows (see _memo docstring)
    cache = _memo.active()
    mkey = None
    if cache is not None:
        mkey = ("sigma", para, extK.tobytes(), subdiagram, name, blocks)
        hit = cache.get(mkey)
        if hit is not None:
            return list(hit)

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
        """Σ = G*(2 W↑↑ - W↑↓); the ↑↓ sign is from spin symmetry
        (sigma.jl:53-73)."""
        if group["response"] not in (UpUp, UpDown):
            raise ValueError("GW->Σ only works for UpUp or UpDown")
        response, vtype = group["response"], group["type"]
        sid = SigmaId(para, vtype, k=extK, t=group["extT"])
        g = green(para_g, K, group["GT"], True,
                  name=("Gfock" if oW == 0 else "G_Σ"), blocks=blocks)
        if not isinstance(g, Graph):
            raise AssertionError("green function must return a Graph")
        spinfactor = 2 if response == UpUp else -1
        if oW > 0:  # composite Σ carries a symmetry factor 1/2
            spinfactor *= 0.5
        sigmadiag = Graph([g, group["diagram"]], properties=sid, operator=PROD,
                          factor=spinfactor, name=name)
        return dict(type=vtype, extT=group["extT"], diagram=sigmadiag)

    for oG, oW in ordered_partition(para.innerLoopNum - 1, 2, 0):
        idx, max_loop = find_first_loop_idx([oW, oG], loop_idx + 1)
        if max_loop > para.totalLoopNum:
            raise AssertionError(f"maxLoop = {max_loop} > {para.totalLoopNum}")
        w_first_loop, g_first_loop = idx

        # W first: the left-in of W is also Σ's incoming leg (same Tidx)
        idx, max_tau = find_first_tau_idx([oW, oG], [Ver4Diag, GreenDiag],
                                          para.firstTauIdx,
                                          interaction_tau_num(para.hasTau, para.interaction))
        if max_tau > para.totalTauNum:
            raise AssertionError(f"maxTau = {max_tau} > {para.totalTauNum}")
        w_first_tau, g_first_tau = idx

        para_g = reconstruct_para(para, type=GreenDiag, innerLoopNum=oG,
                                  firstLoopIdx=g_first_loop, firstTauIdx=g_first_tau)
        para_w = reconstruct_para(para, type=Ver4Diag, innerLoopNum=oW,
                                  firstLoopIdx=w_first_loop, firstTauIdx=w_first_tau)

        if not is_valid_g(para_g):
            continue
        if oW == 0:  # Fock-type Σ
            if NoHartree in para_w.filter:
                para_w0 = reconstruct_para(
                    para_w, filter=tuple(dict.fromkeys(list(para_w.filter) + [Proper])),
                    transferLoop=tuple(np.zeros_like(K)))
                ver4 = vertex4(para_w0, legK, True, channels=[])
            else:
                ver4 = vertex4(para_w, legK, True, channels=[])
        else:  # composite Σ
            ver4 = vertex4(para_w, legK, True, channels=[PHr], blocks=blocks,
                           blockstoplevel=ParquetBlocks(phi=(), Gamma4=(PHr, PHEr, PPr, Alli)))

        # split extT into Σ's extT and G's tau pair
        rows = []
        for row in ver4:
            x = row["extT"]
            rows.append(dict(row, extT=(x[INL], x[OUTR]), GT=(x[OUTL], x[INR])))
        groups = mergeby(rows, ["response", "type", "GT", "extT"], operator=SUM)
        for merged in groups:
            composite_sigma.append(gw_to_sigma(merged, oW, para_g))

    if not composite_sigma:
        if cache is not None:
            cache[mkey] = []
        return composite_sigma
    sigmadf = mergeby(composite_sigma, ["type", "extT"], name=name,
                      getid=lambda g: SigmaId(para, g[0]["type"], k=extK, t=g[0]["extT"]))
    for row in sigmadf:
        if row["extT"][0] != para.firstTauIdx:
            raise AssertionError(f"all sigma should share the same in-Tidx\n{sigmadf}")
    if cache is not None:
        cache[mkey] = list(sigmadf)
    return sigmadf
