"""Physics vocabulary shared by all diagram generators.

Reference: FeynmanDiagram.jl/src/frontend/frontends.jl:9-46.
"""
from __future__ import annotations

from enum import Enum, IntEnum


class TwoBodyChannel(IntEnum):
    """Two-body scattering channels (frontends.jl:9)."""
    Alli = 1   # fully irreducible
    PHr = 2    # particle-hole reducible
    PHEr = 3   # particle-hole-exchange reducible
    PPr = 4    # particle-particle reducible
    AnyChan = 5


Alli = TwoBodyChannel.Alli
PHr = TwoBodyChannel.PHr
PHEr = TwoBodyChannel.PHEr
PPr = TwoBodyChannel.PPr
AnyChan = TwoBodyChannel.AnyChan


class Filter(IntEnum):
    """Diagram filters (frontends.jl:11-19)."""
    Wirreducible = 0   # remove all polarization subdiagrams
    Girreducible = 1   # remove all self-energy insertions
    NoHartree = 2
    NoFock = 3
    NoBubble = 4       # remove all bubble subdiagrams
    Proper = 5         # irreducible along the transfer momentum
    DirectOnly = 6     # only direct interaction (debug)


Wirreducible = Filter.Wirreducible
Girreducible = Filter.Girreducible
NoHartree = Filter.NoHartree
NoFock = Filter.NoFock
NoBubble = Filter.NoBubble
Proper = Filter.Proper
DirectOnly = Filter.DirectOnly


class Response(IntEnum):
    """Spin/charge response channels (frontends.jl:25-33)."""
    Composite = 0
    ChargeCharge = 1
    SpinSpin = 2
    ProperChargeCharge = 3
    ProperSpinSpin = 4
    UpUp = 5
    UpDown = 6


Composite = Response.Composite
ChargeCharge = Response.ChargeCharge
SpinSpin = Response.SpinSpin
ProperChargeCharge = Response.ProperChargeCharge
ProperSpinSpin = Response.ProperSpinSpin
UpUp = Response.UpUp
UpDown = Response.UpDown


class AnalyticProperty(IntEnum):
    """Instant vs dynamic interaction (frontends.jl:39-42)."""
    Instant = 0
    Dynamic = 1


Instant = AnalyticProperty.Instant
Dynamic = AnalyticProperty.Dynamic


def short(x) -> str:
    if isinstance(x, Response):
        return {Response.ChargeCharge: "cc", Response.SpinSpin: "σσ",
                Response.UpUp: "↑↑", Response.UpDown: "↑↓"}.get(x, x.name)
    if isinstance(x, AnalyticProperty):
        return {AnalyticProperty.Instant: "Ins", AnalyticProperty.Dynamic: "Dyn"}[x]
    return str(x)


def vec_allclose(a, b, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """np.allclose semantics for short 1-D momentum vectors without ufunc
    dispatch overhead (hot in parquet generation)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if abs(x - y) > atol + rtol * abs(y):
            return False
    return True
