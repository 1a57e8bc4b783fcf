"""The parquet 4-point-vertex recursion.

Reference: FeynmanDiagram.jl/src/frontend/parquet/vertex4.jl.  The returned
diagram table is a list of rows {response, type, extT, diagram}.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import (DI, EX, INL, OUTL, INR, OUTR, DiagPara, Di, Ex, Permutation,
               GreenDiag, Ver4Diag, ParquetBlocks, SYM_FACTOR, reconstruct_para,
               interaction_tau_num)
from ..common import (Alli, AnyChan, PHr, PHEr, PPr, TwoBodyChannel,
                      DirectOnly, NoBubble, Girreducible,
                      ChargeCharge, SpinSpin, UpDown, UpUp, Response,
                      AnalyticProperty, Dynamic, Instant)
from ..diagram_id import BareInteractionId, GenericId, Ver4Id
from ...computational_graph import Graph, PROD, SUM
from .common import find_first_loop_idx, find_first_tau_idx, ordered_partition
from .filters import is_valid_g, not_proper
from .operation import mergeby

# cache of fully-irreducible (Alli) vertex4 diagrams, seeded from the GV
# module tables at orders 3 and 4 (parquet.jl:211-235).  Keyed by the
# generation config (filter set, spin polarization) so interleaved builds
# with different configs cannot overwrite each other's tables.
_vertex4I_cache: Dict[tuple, Dict[int, List[Graph]]] = {}


def _ver4I_key(filter, spin_polar_para: float) -> tuple:
    from ..common import NoHartree
    if filter is None:
        filter = [NoHartree]
    return (tuple(sorted(filter, key=repr)), float(spin_polar_para))


def initialize_vertex4I_diags(*, filter=None, spin_polar_para: float = 0.0) -> None:
    from ..gv import diagsGV_ver4
    from ..common import NoHartree
    if filter is None:
        filter = [NoHartree]
    tables = {
        3: diagsGV_ver4(3, channels=[Alli], filter=filter,
                        spin_polar_para=spin_polar_para),
        4: diagsGV_ver4(4, channels=[Alli], filter=filter,
                        spin_polar_para=spin_polar_para),
    }
    _vertex4I_cache[_ver4I_key(filter, spin_polar_para)] = tables


def get_ver4I(*, filter=None, spin_polar_para: float = 0.0) -> Dict[int, List[Graph]]:
    """Tables for one generation config (empty dict if not yet initialized)."""
    return _vertex4I_cache.get(_ver4I_key(filter, spin_polar_para), {})


def max_ver4_tau_idx(para: DiagPara) -> int:
    return (para.innerLoopNum + 1) * interaction_tau_num(para.hasTau, para.interaction) \
        + para.firstTauIdx - 1


def max_ver4_loop_idx(para: DiagPara) -> int:
    return para.firstLoopIdx + para.innerLoopNum - 1


from . import _memo
from ...utils.profiling import phased

@phased("vertex4")
@_memo.scoped
def vertex4(para: DiagPara, extK=None, subdiagram: bool = False, *,
            channels: Sequence[TwoBodyChannel] = (PHr, PHEr, PPr, Alli),
            level: int = 1, name: str = "none",
            blocks: ParquetBlocks = ParquetBlocks(),
            blockstoplevel: Optional[ParquetBlocks] = None) -> List[dict]:
    """Generate 4-vertex diagrams via the parquet algorithm (vertex4.jl:27-99).

    ``extK``: [left-in, left-out, right-in] momentum basis vectors; the
    right-out leg is inferred from conservation.
    """
    from .common import get_k

    if extK is None:
        extK = [get_k(para.totalLoopNum, 1), get_k(para.totalLoopNum, 2),
                get_k(para.totalLoopNum, 3)]
    if blockstoplevel is None:
        blockstoplevel = blocks

    for k in extK:
        if len(k) < para.totalLoopNum:
            raise ValueError(f"expect dim of extK >= {para.totalLoopNum}, got {len(k)}")
    legK = [np.asarray(k[:para.totalLoopNum], float) for k in extK[:3]]
    legK.append(legK[0] + legK[2] - legK[1])

    # repeated subproblem? return the shared rows (see _memo docstring);
    # the row dicts are never mutated by consumers, the list is copied
    cache = _memo.active()
    mkey = None
    if cache is not None:
        mkey = ("ver4", para, tuple(k.tobytes() for k in legK[:3]), subdiagram,
                tuple(channels), level, name, blocks, blockstoplevel)
        hit = cache.get(mkey)
        if hit is not None:
            return list(hit)

    if para.totalTauNum < max_ver4_tau_idx(para):
        raise ValueError(f"Increase totalTauNum! {para}")
    if para.totalLoopNum < max_ver4_loop_idx(para):
        raise ValueError(f"Increase totalLoopNum! {para}")

    phi, ppi = blocks.phi, blocks.ppi
    phi_top, ppi_top = blockstoplevel.phi, blockstoplevel.ppi
    for block, bname in ((phi, "phi"), (phi_top, "phi_toplevel")):
        if PHr in block:
            raise ValueError(f"PHr channel is not allowed in {bname}")
    for block, bname in ((ppi, "ppi"), (ppi_top, "ppi_toplevel")):
        if PPr in block:
            raise ValueError(f"PPr channel is not allowed in {bname}")

    loop_num = para.innerLoopNum
    ver4df: List[dict] = []

    if loop_num == 0:
        permutation = [Di] if DirectOnly in para.filter else [Di, Ex]
        bare_ver4(ver4df, para, legK, permutation)
    else:
        for c in channels:
            if c == Alli:
                if 3 <= loop_num <= 4:
                    add_alli(ver4df, para, legK)
                continue
            if c in (PHr, PHEr, PPr):
                for p in ordered_partition(loop_num - 1, 4, 0):
                    bubble(ver4df, para, legK, c, p, level, name, blocks,
                           blockstoplevel, 1.0)
            if (NoBubble in para.filter) and c in (PHr, PHEr):
                rpa_chain(ver4df, para, legK, c, level, name, -1.0)

    ver4df = merge_vertex4(para, ver4df, name, legK)
    for row in ver4df:
        if row["extT"][0] != para.firstTauIdx:
            raise AssertionError(
                f"not all extT[1] equal the first Tau index {para.firstTauIdx}")
    if cache is not None:
        cache[mkey] = list(ver4df)
    return ver4df


def merge_vertex4(para: DiagPara, ver4df: List[dict], name: str, legK) -> List[dict]:
    for row in ver4df:
        if not isinstance(row["diagram"].properties, Ver4Id):
            raise AssertionError("not all ids are Ver4Id")
    if ver4df:
        ver4df = mergeby(ver4df, ["response", "type", "extT"], name=name,
                         getid=lambda g: Ver4Id(para, g[0]["response"], g[0]["type"],
                                                k=legK, t=g[0]["extT"]))
    return ver4df


def add_alli(ver4df: List[dict], para: DiagPara, legK) -> None:
    """Insert cached fully-irreducible vertex diagrams rebased onto this
    sub-problem's momenta/times (vertex4.jl:115-123)."""
    from .operation import update_extKT

    dict_graphs = get_ver4I()
    if para.innerLoopNum not in dict_graphs:
        try:  # lazy init from the GV tables on first use
            initialize_vertex4I_diags()
        except (FileNotFoundError, RuntimeError) as exc:
            raise RuntimeError(
                "vertex4I tables not initialized and GV tables unavailable; "
                "call parquet.vertex4.initialize_vertex4I_diags() after "
                "configuring frontends.gv table path") from exc
        dict_graphs = get_ver4I()
    graphvec = dict_graphs[para.innerLoopNum]
    graphvec = update_extKT(graphvec, para, legK, para.firstLoopIdx - 1)
    for ver4diag in graphvec:
        vid = ver4diag.properties
        ver4df.append(dict(response=vid.response, type=vid.type, extT=vid.extT,
                           diagram=ver4diag))


def bubble(ver4df: List[dict], para: DiagPara, legK, chan: TwoBodyChannel,
           partition: Sequence[int], level: int, name: str,
           blocks: ParquetBlocks, blockstoplevel: ParquetBlocks,
           extrafactor: float = 1.0) -> None:
    """One parquet bubble: Γi x G0 x Gx x Γf (vertex4.jl:125-202)."""
    from .green import green

    tau_num = interaction_tau_num(para.hasTau, para.interaction)
    oL, oG0, oR, oGx = partition
    if not is_valid_g(para.filter, oG0) or not is_valid_g(para.filter, oGx):
        return

    loop_idx = para.firstLoopIdx  # the inner loop of the bubble
    idx, max_loop = find_first_loop_idx(partition, loop_idx + 1)
    l_first_loop, g0_first_loop, r_first_loop, gx_first_loop = idx
    if max_loop != max_ver4_loop_idx(para):
        raise AssertionError("loop index accounting mismatch")

    types = [Ver4Diag, GreenDiag, Ver4Diag, GreenDiag]
    idx, max_tau = find_first_tau_idx(partition, types, para.firstTauIdx, tau_num)
    l_first_tau, g0_first_tau, r_first_tau, gx_first_tau = idx
    if max_tau != max_ver4_tau_idx(para):
        raise AssertionError(
            f"Partition {partition}: maxTau {max_tau} != {max_ver4_tau_idx(para)}")

    l_para = reconstruct_para(para, type=Ver4Diag, innerLoopNum=oL,
                              firstLoopIdx=l_first_loop, firstTauIdx=l_first_tau)
    r_para = reconstruct_para(para, type=Ver4Diag, innerLoopNum=oR,
                              firstLoopIdx=r_first_loop, firstTauIdx=r_first_tau)
    gx_para = reconstruct_para(para, type=GreenDiag, innerLoopNum=oGx,
                               firstLoopIdx=gx_first_loop, firstTauIdx=gx_first_tau)
    g0_para = reconstruct_para(para, type=GreenDiag, innerLoopNum=oG0,
                               firstLoopIdx=g0_first_loop, firstTauIdx=g0_first_tau)

    if chan in (PHr, PHEr):
        gamma_i = blockstoplevel.phi if level == 1 else blocks.phi
        gamma_f = blockstoplevel.Gamma4 if level == 1 else blocks.Gamma4
    elif chan == PPr:
        gamma_i = blockstoplevel.ppi if level == 1 else blocks.ppi
        gamma_f = blockstoplevel.Gamma4 if level == 1 else blocks.Gamma4
    else:
        raise ValueError(f"channel {chan} not implemented")

    LLegK, K, RLegK, Kx = leg_basis(chan, legK, loop_idx)

    Lver = vertex4(l_para, LLegK, True, channels=gamma_i, level=level + 1,
                   name="Γi", blocks=blocks)
    if not Lver:
        return
    Rver = vertex4(r_para, RLegK, True, channels=gamma_f, level=level + 1,
                   name="Γf", blocks=blocks)
    if not Rver:
        return

    ver8: Dict[tuple, list] = {}
    for lrow in Lver:
        for rrow in Rver:
            ldiag, rdiag = lrow["diagram"], rrow["diagram"]
            bubble2diag(ver8, para, chan, ldiag, rdiag, legK, extrafactor)

    for key, terms in ver8.items():
        G0T, GxT, extT, v_response, vtype = key
        if not terms:
            continue
        g0 = green(g0_para, K, G0T, True, name="G0", blocks=blocks)
        gx = green(gx_para, Kx, GxT, True, name="Gx", blocks=blocks)
        if not isinstance(g0, Graph) or not isinstance(gx, Graph):
            raise AssertionError("green must return a Graph here")
        vid = Ver4Id(para, v_response, vtype, k=legK, t=extT, chan=chan)
        if len(terms) == 1:
            diag = Graph([terms[0], g0, gx], properties=vid, operator=PROD)
        else:
            inner = Graph(terms, properties=GenericId(para), operator=SUM)
            diag = Graph([inner, g0, gx], properties=vid, operator=PROD)
        ver4df.append(dict(response=v_response, type=vtype, extT=extT, diagram=diag))


def rpa_chain(ver4df: List[dict], para: DiagPara, legK, chan: TwoBodyChannel,
              level: int, name: str, extrafactor: float = 1.0) -> None:
    """RPA bubble counter-diagram chain removing the bubble (vertex4.jl:204-213)."""
    if chan not in (PHr, PHEr):
        return
    new_filter = tuple(dict.fromkeys(list(para.filter) + [Girreducible, DirectOnly]))
    para_rpa = reconstruct_para(para, filter=new_filter)
    rpa_blocks = ParquetBlocks(phi=(), ppi=(), Gamma4=(PHr,))
    bubble(ver4df, para_rpa, legK, chan, [0, 0, para.innerLoopNum - 1, 0], level,
           f"{name}_RPA_CT", rpa_blocks, rpa_blocks, extrafactor)


def bubble2diag(ver8: Dict[tuple, list], para: DiagPara, chan: TwoBodyChannel,
                ldiag: Graph, rdiag: Graph, extK, extrafactor: float) -> None:
    """Spin recoupling of the left x right sub-vertices (vertex4.jl:215-274)."""
    lid, rid = ldiag.properties, rdiag.properties
    ln, rn = lid.response, rid.response
    vtype = type_map(lid.type, rid.type)
    extT, G0T, GxT = tau_basis(chan, lid.extT, rid.extT)
    factor = sym_factor(para, chan) * extrafactor

    def spin(response):
        return "↑↑" if response == UpUp else "↑↓"

    def add(l_response, r_response, v_response, f=1.0):
        key = (G0T, GxT, extT, v_response, vtype)
        ver8.setdefault(key, [])
        if ln == l_response and rn == r_response:
            node_name = f"{spin(l_response)}x{spin(r_response)} → {chan.name},"
            diag = Graph([ldiag, rdiag], properties=GenericId(para), operator=PROD,
                         factor=f * factor, name=node_name)
            ver8[key].append(diag)

    if chan == PHr:
        add(UpUp, UpUp, UpUp, 1.0)
        add(UpDown, UpDown, UpUp, 1.0)
        add(UpUp, UpDown, UpDown, 1.0)
        add(UpDown, UpUp, UpDown, 1.0)
    elif chan == PHEr:
        add(UpUp, UpUp, UpUp, 1.0)
        add(UpDown, UpDown, UpUp, 1.0)
        # SU(2): v(↑↓↓↑) = v_uu - v_ud; crossing gives the minus signs
        add(UpUp, UpUp, UpDown, 1.0)
        add(UpDown, UpDown, UpDown, 1.0)
        add(UpUp, UpDown, UpDown, -1.0)
        add(UpDown, UpUp, UpDown, -1.0)
    elif chan == PPr:
        add(UpUp, UpUp, UpUp, 1.0)
        # SU(2): (vl_uu - vl_ud)*vr_ud + vl_ud*(vr_uu - vr_ud)
        add(UpDown, UpDown, UpDown, -2.0)
        add(UpUp, UpDown, UpDown, 1.0)
        add(UpDown, UpUp, UpDown, 1.0)
    else:
        raise ValueError(f"channel {chan} not implemented")


def _bare(para: DiagPara, diex: Sequence[Permutation], response: Response,
          vtype: AnalyticProperty, _diex: Permutation, inner_t, q,
          factor: float = 1.0) -> Optional[Graph]:
    """A single bare-interaction leaf with the Taylor-expansion sign
    (vertex4.jl:276-296)."""
    if _diex == Di:
        sign = -1.0
    elif _diex == Ex:
        sign = 1.0 if para.isFermi else -1.0
    else:
        raise ValueError("not implemented")
    if not not_proper(para, q) and _diex in diex:
        vid = BareInteractionId(response, vtype, k=q, t=inner_t)
        return Graph([], factor=sign * factor, properties=vid)
    return None


def _push_bare_ver4(para: DiagPara, nodes: List[dict], response: Response,
                    vtype: AnalyticProperty, extT, legK, vd, ve) -> None:
    if vd is not None:
        id_di = Ver4Id(para, response, vtype, k=legK, t=extT[DI])
        nodes.append(dict(response=response, type=vtype, extT=extT[DI],
                          diagram=Graph([vd], operator=SUM, properties=id_di)))
    if ve is not None:
        id_ex = Ver4Id(para, response, vtype, k=legK, t=extT[EX])
        nodes.append(dict(response=response, type=vtype, extT=extT[EX],
                          diagram=Graph([ve], operator=SUM, properties=id_ex)))


def _push_bare_with_response(para: DiagPara, nodes: List[dict], response: Response,
                             vtype: AnalyticProperty, legK, q, diex, extT, innerT) -> None:
    """(vertex4.jl:311-348)."""
    if response == UpUp:
        vd = _bare(para, diex, response, vtype, Di, innerT[DI], q[DI])
        ve = _bare(para, diex, response, vtype, Ex, innerT[EX], q[EX])
        _push_bare_ver4(para, nodes, UpUp, vtype, extT, legK, vd, ve)
    elif response == UpDown:
        vd = _bare(para, diex, UpDown, vtype, Di, innerT[DI], q[DI])
        _push_bare_ver4(para, nodes, UpDown, vtype, extT, legK, vd, None)
    elif response == ChargeCharge:
        vuud = _bare(para, diex, ChargeCharge, vtype, Di, innerT[DI], q[DI])
        vuue = _bare(para, diex, ChargeCharge, vtype, Ex, innerT[EX], q[EX])
        _push_bare_ver4(para, nodes, UpUp, vtype, extT, legK, vuud, vuue)
        # UpDown: exchange does not exist for charge-charge
        vupd = _bare(para, diex, ChargeCharge, vtype, Di, innerT[DI], q[DI])
        _push_bare_ver4(para, nodes, UpDown, vtype, extT, legK, vupd, None)
    elif response == SpinSpin:
        vuud = _bare(para, diex, SpinSpin, vtype, Di, innerT[DI], q[DI])
        vuue = _bare(para, diex, SpinSpin, vtype, Ex, innerT[EX], q[EX])
        _push_bare_ver4(para, nodes, UpUp, vtype, extT, legK, vuud, vuue)
        vupd = _bare(para, diex, SpinSpin, vtype, Di, innerT[DI], q[DI], -1.0)
        vupe = _bare(para, diex, SpinSpin, vtype, Ex, innerT[EX], q[EX], 2.0)
        _push_bare_ver4(para, nodes, UpDown, vtype, extT, legK, vupd, vupe)
    else:
        raise ValueError(f"response {response} not implemented")


def bare_ver4(nodes: List[dict], para: DiagPara, legK,
              diex: Sequence[Permutation] = (Di, Ex), leftalign: bool = True) -> None:
    """All bare 4-vertices for the configured interactions (vertex4.jl:350-408)."""
    KinL, KoutL, KinR = legK[0], legK[1], legK[2]
    t0 = para.firstTauIdx
    q = [KinL - KoutL, KinR - KoutL]

    if para.hasTau:
        extT_ins = [(t0, t0, t0, t0), (t0, t0, t0, t0)]
        extT_ins_rightalign = [(t0 + 1,) * 4, (t0 + 1,) * 4]
        extT_dyn = [(t0, t0, t0 + 1, t0 + 1), (t0, t0 + 1, t0 + 1, t0)]
        innerT_ins = [(1, 1), (1, 1)]
        innerT_dyn = [(t0, t0 + 1), (t0, t0 + 1)]
    else:
        extT_ins = [(t0, t0, t0, t0), (t0, t0, t0, t0)]
        extT_dyn = extT_ins
        innerT_ins = [(1, 1), (1, 1)]
        innerT_dyn = innerT_ins

    for inter in para.interaction:
        response = inter.response
        type_vec = inter.type
        if Instant in type_vec and Dynamic not in type_vec:
            _push_bare_with_response(para, nodes, response, Instant, legK, q, diex,
                                     extT_ins, innerT_ins)
        elif Instant not in type_vec and Dynamic in type_vec:
            _push_bare_with_response(para, nodes, response, Dynamic, legK, q, diex,
                                     extT_dyn, innerT_dyn)
        elif Instant in type_vec and Dynamic in type_vec:
            # with tau, instant gets an auxiliary time making it dynamic-like
            if leftalign:
                _push_bare_with_response(para, nodes, response, Instant, legK, q, diex,
                                         extT_ins, innerT_dyn)
            else:
                _push_bare_with_response(para, nodes, response, Instant, legK, q, diex,
                                         extT_ins_rightalign, innerT_dyn)
            _push_bare_with_response(para, nodes, response, Dynamic, legK, q, diex,
                                     extT_dyn, innerT_dyn)


def leg_basis(chan: TwoBodyChannel, legK, loop_idx: int):
    """Momentum routing of a bubble (vertex4.jl:414-440); loop_idx is 1-based."""
    KinL, KoutL, KinR, KoutR = legK[0], legK[1], legK[2], legK[3]
    K = np.zeros_like(KinL)
    K[loop_idx - 1] = 1
    if chan == PHr:
        Kx = KoutL + K - KinL
        LLegK = [KinL, KoutL, Kx, K]
        RLegK = [K, Kx, KinR, KoutR]
    elif chan == PHEr:
        Kx = KoutR + K - KinL
        LLegK = [KinL, KoutR, Kx, K]
        RLegK = [K, Kx, KinR, KoutL]
    elif chan == PPr:
        Kx = KinL + KinR - K
        LLegK = [KinL, Kx, KinR, K]
        RLegK = [K, KoutL, Kx, KoutR]
    else:
        raise ValueError(f"channel {chan} not implemented")
    if not np.allclose(LLegK[INL] + LLegK[INR], LLegK[OUTL] + LLegK[OUTR]):
        raise AssertionError("left sub-vertex momentum not conserved")
    if not np.allclose(RLegK[INL] + RLegK[INR], RLegK[OUTL] + RLegK[OUTR]):
        raise AssertionError("right sub-vertex momentum not conserved")
    return LLegK, K, RLegK, Kx


def tau_basis(chan: TwoBodyChannel, LvT, RvT):
    """τ routing of a bubble (vertex4.jl:442-463)."""
    G0T = (LvT[OUTR], RvT[INL])
    if chan == PHr:
        extT = (LvT[INL], LvT[OUTL], RvT[INR], RvT[OUTR])
        GxT = (RvT[OUTL], LvT[INR])
    elif chan == PHEr:
        extT = (LvT[INL], RvT[OUTR], RvT[INR], LvT[OUTL])
        GxT = (RvT[OUTL], LvT[INR])
    elif chan == PPr:
        extT = (LvT[INL], RvT[OUTL], LvT[INR], RvT[OUTR])
        GxT = (LvT[OUTL], RvT[INR])
    else:
        raise ValueError(f"channel {chan} not implemented")
    t1 = sorted(list(G0T) + list(GxT) + list(extT))
    t2 = sorted(list(LvT) + list(RvT))
    if t1 != t2:
        raise AssertionError(
            f"chan {chan}: G0={G0T}, Gx={GxT}, external={extT} do not match "
            f"Lver4 {LvT} and Rver4 {RvT}")
    if extT[INL] != LvT[INL]:
        raise AssertionError("extT[INL] must equal LvT[INL]")
    return extT, G0T, GxT


def sym_factor(para: DiagPara, chan: TwoBodyChannel) -> float:
    f = SYM_FACTOR[chan]
    return abs(f) if not para.isFermi else f


def type_map(ltype: AnalyticProperty, rtype: AnalyticProperty) -> AnalyticProperty:
    return Dynamic
