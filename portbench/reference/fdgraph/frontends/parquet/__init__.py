"""Parquet front end: recursive generator of Σ/Π/Γ3/Γ4/G diagram graphs from
the parquet + Dyson-Schwinger equations.

Reference: FeynmanDiagram.jl/src/frontend/parquet/.  Tau and loop indices are
1-based exactly as in the reference (so extT tuples, firstTauIdx etc. match
the reference oracles bit-for-bit); they are converted to 0-based only when
indexing momentum-basis arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import Any, FrozenSet, List, Optional, Sequence, Tuple

from ..common import (TwoBodyChannel, Alli, PHr, PHEr, PPr, AnyChan,
                      Filter, NoBubble, NoHartree, NoFock, DirectOnly,
                      Wirreducible, Girreducible, Proper,
                      Response, Composite, ChargeCharge, SpinSpin, UpUp, UpDown,
                      AnalyticProperty, Instant, Dynamic, short)

DI, EX, BOTH = 0, 1, 2                 # direct / exchange slots (0-based)
INL, OUTL, INR, OUTR = 0, 1, 2, 3      # external leg slots (0-based)

# symmetry factors for [Alli, PHr, PHEr, PPr, PHrc, PHErc] (parquet.jl:32)
SYM_FACTOR = {Alli: 1.0, PHr: -1.0, PHEr: 1.0, PPr: -0.5}


class Permutation(IntEnum):
    Di = 1
    Ex = 2
    DiEx = 3


Di, Ex, DiEx = Permutation.Di, Permutation.Ex, Permutation.DiEx


class DiagramType(IntEnum):
    """Diagram classes the parquet front end can generate (parquet.jl:44-51)."""
    VacuumDiag = 1
    SigmaDiag = 2
    GreenDiag = 3
    PolarDiag = 4
    Ver3Diag = 5
    Ver4Diag = 6


VacuumDiag = DiagramType.VacuumDiag
SigmaDiag = DiagramType.SigmaDiag
GreenDiag = DiagramType.GreenDiag
PolarDiag = DiagramType.PolarDiag
Ver3Diag = DiagramType.Ver3Diag
Ver4Diag = DiagramType.Ver4Diag


@dataclass(frozen=True)
class Interaction:
    """An interaction channel with its analytic properties (parquet.jl:56-65)."""
    response: Response
    type: FrozenSet[AnalyticProperty]

    def __init__(self, response: Response, type):
        object.__setattr__(self, "response", Response(response))
        if isinstance(type, AnalyticProperty):
            type = [type]
        object.__setattr__(self, "type", frozenset(AnalyticProperty(t) for t in type))

    def __repr__(self):
        return f"{short(self.response)}_{''.join(short(t) for t in sorted(self.type))}"


@dataclass(frozen=True)
class ParquetBlocks:
    """Channel sets for sub-vertices in the parquet bubble (parquet.jl:84-91).

    - phi: left-vertex channels for PH / PHE bubbles (PH-irreducible)
    - ppi: left-vertex channels for PP bubbles (PP-irreducible)
    - Gamma4: right-vertex channels for all bubbles
    """
    phi: Tuple[TwoBodyChannel, ...] = (Alli, PHEr, PPr)
    ppi: Tuple[TwoBodyChannel, ...] = (Alli, PHr, PHEr)
    Gamma4: Optional[Tuple[TwoBodyChannel, ...]] = None

    def __post_init__(self):
        if self.Gamma4 is None:
            union = list(self.phi)
            for c in self.ppi:
                if c not in union:
                    union.append(c)
            object.__setattr__(self, "Gamma4", tuple(union))
        object.__setattr__(self, "phi", tuple(self.phi))
        object.__setattr__(self, "ppi", tuple(self.ppi))
        object.__setattr__(self, "Gamma4", tuple(self.Gamma4))

    def __eq__(self, other):
        if not isinstance(other, ParquetBlocks):
            return NotImplemented
        return (set(self.phi) == set(other.phi) and set(self.ppi) == set(other.ppi)
                and set(self.Gamma4) == set(other.Gamma4))

    def __hash__(self):
        return hash((frozenset(self.phi), frozenset(self.ppi), frozenset(self.Gamma4)))


def interaction_tau_num(has_tau: bool, interactions) -> int:
    """2 if any dynamic interaction, else 1 (0 without tau) (common.jl:72-82)."""
    if not has_tau:
        return 0
    for inter in interactions:
        if Dynamic in inter.type:
            return 2
    return 1


def inner_tau_num(dtype: DiagramType, inner_loop_num: int, interaction_tau: int) -> int:
    """Internal imaginary-time DOF per diagram type (common.jl:54-70)."""
    if dtype == Ver4Diag:
        return (inner_loop_num + 1) * interaction_tau
    if dtype in (SigmaDiag, GreenDiag):
        return inner_loop_num * interaction_tau
    if dtype == VacuumDiag:
        return (inner_loop_num - 1) * interaction_tau
    if dtype == PolarDiag:
        return 1 + inner_tau_num(Ver3Diag, inner_loop_num - 1, interaction_tau)
    if dtype == Ver3Diag:
        return 1 + inner_tau_num(Ver4Diag, inner_loop_num - 1, interaction_tau)
    raise ValueError(f"not implemented for {dtype}")


def first_tau_idx(dtype: DiagramType, offset: int = 0) -> int:
    if dtype == GreenDiag:
        return 3 + offset
    return 1 + offset


def first_loop_idx(dtype: DiagramType, offset: int = 0) -> int:
    return {Ver4Diag: 4, SigmaDiag: 2, GreenDiag: 2, PolarDiag: 2,
            Ver3Diag: 3, VacuumDiag: 1}[dtype] + offset


_DEFAULT_INTERACTION = (Interaction(ChargeCharge, [Instant]),)


@dataclass(frozen=True)
class DiagPara:
    """Parameters of a parquet sub-problem (parquet.jl:102-122).

    Pure data: a frozen, hashable dataclass.  Derived fields take their
    reference defaults when not supplied.
    """
    type: DiagramType
    innerLoopNum: int
    isFermi: bool = True
    spin: int = 2
    interaction: Tuple[Interaction, ...] = _DEFAULT_INTERACTION
    firstLoopIdx: int = -1
    totalLoopNum: int = -1
    hasTau: bool = True
    firstTauIdx: int = -1
    totalTauNum: int = -1
    filter: Tuple[Filter, ...] = (NoHartree,)
    transferLoop: Tuple[float, ...] = ()
    extra: Any = None

    def __post_init__(self):
        object.__setattr__(self, "type", DiagramType(self.type))
        object.__setattr__(self, "interaction", tuple(self.interaction))
        object.__setattr__(self, "filter", tuple(self.filter))
        object.__setattr__(self, "transferLoop", tuple(float(x) for x in self.transferLoop))
        if self.firstLoopIdx < 0:
            object.__setattr__(self, "firstLoopIdx", first_loop_idx(self.type))
        if self.totalLoopNum < 0:
            object.__setattr__(self, "totalLoopNum", self.firstLoopIdx + self.innerLoopNum - 1)
        if self.firstTauIdx < 0:
            object.__setattr__(self, "firstTauIdx", first_tau_idx(self.type))
        if self.totalTauNum < 0:
            itau = interaction_tau_num(self.hasTau, self.interaction)
            object.__setattr__(self, "totalTauNum",
                               self.firstTauIdx + inner_tau_num(self.type, self.innerLoopNum, itau) - 1)

    @property
    def interactionTauNum(self) -> int:
        return interaction_tau_num(self.hasTau, self.interaction)

    @property
    def innerTauNum(self) -> int:
        return inner_tau_num(self.type, self.innerLoopNum, self.interactionTauNum)

    def __eq__(self, other):
        """Reference equality: filters as sets, interactions as sets,
        transferLoop ≈ (parquet.jl:178-203)."""
        if not isinstance(other, DiagPara):
            return NotImplemented
        if set(self.filter) != set(other.filter):
            return False
        if bool(self.transferLoop) != bool(other.transferLoop):
            return False
        if self.transferLoop and other.transferLoop:
            if len(self.transferLoop) != len(other.transferLoop):
                return False
            if any(abs(a - b) > 1e-8 for a, b in zip(self.transferLoop, other.transferLoop)):
                return False
        if set(self.interaction) != set(other.interaction):
            return False
        return (self.type == other.type and self.innerLoopNum == other.innerLoopNum
                and self.isFermi == other.isFermi and self.spin == other.spin
                and self.firstLoopIdx == other.firstLoopIdx
                and self.totalLoopNum == other.totalLoopNum
                and self.hasTau == other.hasTau
                and self.firstTauIdx == other.firstTauIdx
                and self.totalTauNum == other.totalTauNum
                and self.extra == other.extra)

    def __hash__(self):
        return hash((self.type, self.innerLoopNum, self.isFermi, self.spin,
                     frozenset(self.interaction), self.firstLoopIdx, self.totalLoopNum,
                     self.hasTau, self.firstTauIdx, self.totalTauNum,
                     frozenset(self.filter),
                     tuple(round(x, 8) for x in self.transferLoop)))


def reconstruct_para(p: DiagPara, **kwargs) -> DiagPara:
    """Derive a sub-problem DiagPara, recomputing dependent defaults
    (parquet.jl:132-176).

    Changing ``type``/``innerLoopNum``/``firstTauIdx``/... without passing
    ``totalTauNum`` keeps the parent's total budget (matches the reference,
    which copies unspecified fields from the parent).
    """
    return replace(p, **kwargs)


derivepara = reconstruct_para

from .common import (build, ordered_partition, get_k, find_first_loop_idx,
                     find_first_tau_idx, total_tau_num, total_loop_num)
from .filters import is_valid_g, is_valid_sigma, not_proper, is_valid_polarization
from .operation import mergeby, update_extKT, update_extKT_inplace
from .vertex4 import vertex4
from .sigma import sigma
from .green import green
from .vertex3 import vertex3
from .polarization import polarization
from .ep_coupling import ep_coupling
from .sigma_gv import sigmaGV
from . import benchmark
