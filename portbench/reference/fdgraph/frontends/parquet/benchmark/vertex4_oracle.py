"""Independent legacy-style parquet vertex-4 evaluator (test oracle).

A from-scratch port of the reference ``Parquet.Benchmark.Ver4`` machinery
(benchmark/vertex4.jl + vertex4_eval.jl): the parquet recursion rebuilt with
explicit (direct, exchange) weight tables instead of computational graphs.
It shares NO code with the graph pipeline, so agreement between the two is a
strong end-to-end check of the whole parquet + evaluation stack.

Channels use the legacy integer codes I=1, T=2, U=3, S=4 (equivalent to
Alli, PHr, PHEr, PPr).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import DiagPara, interaction_tau_num

I, T, U, S = 1, 2, 3, 4
SYM_FACTOR = {I: 1.0, T: -1.0, U: 1.0, S: -0.5}
INL, OUTL, INR, OUTR = 0, 1, 2, 3


@dataclass
class Weight:
    d: float = 0.0
    e: float = 0.0


@dataclass
class GreenW:
    tpair: Tuple[int, int]
    weight: float = 0.0


@dataclass
class IdxMap:
    lidx: int
    ridx: int
    vidx: int
    g0: GreenW
    gx: GreenW


class Bubble:
    """One parquet bubble of the oracle tree (benchmark/vertex4.jl:56-147)."""

    def __init__(self, ver4: "Ver4", chan: int, oL: int, level: int):
        if oL >= ver4.loop_num:
            raise ValueError("LVer loopNum must be smaller than the ver4 loopNum")
        self.chan = chan
        para = ver4.para
        oR = ver4.loop_num - 1 - oL
        l_lpidx = ver4.loopidx_offset + 1
        r_lpidx = l_lpidx + oL
        l_tidx = ver4.tidx_offset
        tau_num = interaction_tau_num(para.hasTau, para.interaction)
        r_tidx = l_tidx + (oL + 1) * tau_num

        if chan in (T, U):
            lchan = ver4.F_outer if level == 1 else ver4.F
        elif chan == S:
            lchan = ver4.V_outer if level == 1 else ver4.V
        else:
            raise ValueError(f"chan {chan} isn't implemented!")
        rchan = ver4.All_outer if level == 1 else ver4.All

        self.lver = Ver4(para, lchan, ver4.F, ver4.V, ver4.All, loop_num=oL,
                         loopidx_offset=l_lpidx, tidx_offset=l_tidx, level=level + 1)
        self.rver = Ver4(para, rchan, ver4.F, ver4.V, ver4.All, loop_num=oR,
                         loopidx_offset=r_lpidx, tidx_offset=r_tidx, level=level + 1)
        if self.lver.tidx_offset != ver4.tidx_offset:
            raise AssertionError("Lver Tidx must equal the vertex4 Tidx")

        self.map: List[IdxMap] = []
        for lt, LvT in enumerate(self.lver.tpair):
            for rt, RvT in enumerate(self.rver.tpair):
                if chan == T:
                    VerT = (LvT[INL], LvT[OUTL], RvT[INR], RvT[OUTR])
                    GTx = (RvT[OUTL], LvT[INR])
                elif chan == U:
                    VerT = (LvT[INL], RvT[OUTR], RvT[INR], LvT[OUTL])
                    GTx = (RvT[OUTL], LvT[INR])
                elif chan == S:
                    VerT = (LvT[INL], RvT[OUTL], LvT[INR], RvT[OUTR])
                    GTx = (LvT[OUTL], RvT[INR])
                else:
                    raise ValueError("invalid channel")
                gx = GreenW(GTx)
                ver4.G[chan].append(gx)
                g0 = GreenW((LvT[OUTR], RvT[INL]))
                ver4.G[I].append(g0)
                vidx = ver4.add_tidx(VerT)
                for tpair in ver4.tpair:
                    if tpair[0] != ver4.tidx_offset:
                        raise AssertionError("InL Tidx must be shared by all Tpairs")
                if sorted(LvT + RvT) != sorted(g0.tpair + GTx + VerT):
                    raise AssertionError("tau variables mismatch in bubble")
                self.map.append(IdxMap(lt, rt, vidx, g0, gx))


class Ver4:
    """Oracle 4-vertex (benchmark/vertex4.jl:150-263)."""

    def __init__(self, para: DiagPara, chan=None, F=(I, U, S), V=(I, T, U),
                 All=None, *, loop_num: Optional[int] = None,
                 loopidx_offset: int = 0, tidx_offset: int = 0,
                 F_outer=None, V_outer=None, All_outer=None, level: int = 1):
        if chan is None:
            chan = [T, U, S]
        if All is None:
            All = list(dict.fromkeys(list(F) + list(V)))
        self.para = para
        self.chan = list(chan)
        self.F, self.V, self.All = list(F), list(V), list(All)
        self.F_outer = list(F_outer) if F_outer is not None else self.F
        self.V_outer = list(V_outer) if V_outer is not None else self.V
        self.All_outer = list(All_outer) if All_outer is not None else self.All
        if T in self.F or T in self.F_outer:
            raise ValueError("T channel is not allowed in F (PH-irreducible)")
        if S in self.V or S in self.V_outer:
            raise ValueError("S channel is not allowed in V (PP-irreducible)")
        self.level = level
        self.loop_num = para.innerLoopNum if loop_num is None else loop_num
        self.loopidx_offset = loopidx_offset
        self.tidx_offset = tidx_offset
        self.G = {c: [] for c in (I, T, U, S)}
        self.bubble: List[Bubble] = []
        self.tpair: List[Tuple[int, int, int, int]] = []
        self.weight: List[Weight] = []

        tau_num = interaction_tau_num(para.hasTau, para.interaction)
        if para.totalTauNum < (self.loop_num + 1) * tau_num:
            raise ValueError("totalTauNum too small for the oracle vertex")

        if self.loop_num == 0:
            tidx = tidx_offset
            if tau_num == 1:
                self.add_tidx((tidx, tidx, tidx, tidx))
            elif tau_num == 2:
                self.add_tidx((tidx, tidx, tidx, tidx))
                self.add_tidx((tidx, tidx, tidx + 1, tidx + 1))
                self.add_tidx((tidx, tidx + 1, tidx + 1, tidx))
            else:
                raise NotImplementedError("interactionTauNum == 4")
        else:
            for c in self.chan:
                if c == I:
                    continue  # fully irreducible envelopes not supported
                for ol in range(self.loop_num):
                    bub = Bubble(self, c, ol, level)
                    if bub.map:
                        self.bubble.append(bub)

    def add_tidx(self, tidx: Tuple[int, int, int, int]) -> int:
        for i, tp in enumerate(self.tpair):
            if tp == tidx:
                return i
        self.tpair.append(tidx)
        self.weight.append(Weight())
        return len(self.tpair) - 1


def _eval_all_g(greens: List[GreenW], K, t0idx: int, varT, evalG: Callable) -> None:
    for g in greens:
        tin, tout = g.tpair
        g.weight = evalG(K, varT[t0idx + tin - 1], varT[t0idx + tout - 1])


def eval_ver4(para: DiagPara, ver4: Ver4, varK, varT, legK,
              evalG: Callable, evalV: Callable, fast: bool = False) -> None:
    """Recursive weight-table evaluation (benchmark/vertex4_eval.jl:28-139).

    ``varK``: [dim, totalLoopNum]; ``varT``: [totalTauNum] (0-based arrays,
    tau/loop slot indices remain 1-based as in DiagPara).
    """
    KinL, KoutL, KinR, KoutR = legK
    spin = para.spin
    t0idx = para.firstTauIdx
    kidx = para.firstLoopIdx + ver4.loopidx_offset

    if ver4.loop_num == 0:
        qd = KinL - KoutL
        qe = KinL - KoutR
        if interaction_tau_num(para.hasTau, para.interaction) == 1:
            sign = -1 if para.isFermi else 1
            ver4.weight[0].d = -evalV(qd)
            ver4.weight[0].e = (-evalV(qe)) * sign
        else:
            raise NotImplementedError("dynamic interactions in the oracle")
        return

    for w in ver4.weight:
        w.d, w.e = 0.0, 0.0
    K = varK[:, kidx - 1]
    _eval_all_g(ver4.G[I], K, t0idx, varT, evalG)

    Kt = KoutL + K - KinL
    Ku = KoutR + K - KinL
    Ks = KinL + KinR - K
    for c in ver4.chan:
        if c == T:
            _eval_all_g(ver4.G[T], Kt, t0idx, varT, evalG)
        elif c == U:
            _eval_all_g(ver4.G[U], Ku, t0idx, varT, evalG)
        elif c == S:
            _eval_all_g(ver4.G[S], Ks, t0idx, varT, evalG)

    for b in ver4.bubble:
        c = b.chan
        factor = SYM_FACTOR[c]
        if not para.isFermi:
            factor = abs(factor)
        if c == T:
            eval_ver4(para, b.lver, varK, varT, [KinL, KoutL, Kt, K], evalG, evalV, fast)
            eval_ver4(para, b.rver, varK, varT, [K, Kt, KinR, KoutR], evalG, evalV, fast)
        elif c == U:
            eval_ver4(para, b.lver, varK, varT, [KinL, KoutR, Ku, K], evalG, evalV, fast)
            eval_ver4(para, b.rver, varK, varT, [K, Ku, KinR, KoutL], evalG, evalV, fast)
        elif c == S:
            eval_ver4(para, b.lver, varK, varT, [KinL, Ks, KinR, K], evalG, evalV, fast)
            eval_ver4(para, b.rver, varK, varT, [K, KoutL, Ks, KoutR], evalG, evalV, fast)
        else:
            raise ValueError("not implemented")

        rN = len(b.rver.weight)
        for l, Lw in enumerate(b.lver.weight):
            for r, Rw in enumerate(b.rver.weight):
                m = b.map[l * rN + r]
                g_weight = m.g0.weight * m.gx.weight * factor
                if fast and ver4.level == 1:
                    w = ver4.weight[0]
                else:
                    w = ver4.weight[m.vidx]
                if c == T:
                    w.d += g_weight * (Lw.d * Rw.d * spin + Lw.d * Rw.e + Lw.e * Rw.d)
                    w.e += g_weight * Lw.e * Rw.e
                elif c == U:
                    w.d += g_weight * Lw.e * Rw.e
                    w.e += g_weight * (Lw.d * Rw.d * spin + Lw.d * Rw.e + Lw.e * Rw.d)
                elif c == S:
                    w.d += g_weight * (Lw.d * Rw.e + Lw.e * Rw.d)
                    w.e += g_weight * (Lw.d * Rw.d + Lw.e * Rw.e)
