"""DiagramId hierarchy: typed node/leaf metadata — the "symbol table" keying
leaf evaluation and AD variable dependence.

Reference: FeynmanDiagram.jl/src/frontend/diagram_id.jl.  Momenta (``extK``)
are stored as tuples of floats; equality follows the reference exactly,
including BareInteractionId's τ-symmetric rule, and every id is hashable
consistently with its equality so the optimizer's structural-hash CSE can
merge equivalent leaves in O(N).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as _np

from .common import AnalyticProperty, Dynamic, Instant, Response, TwoBodyChannel, AnyChan, short

_ROUND = 8  # digits for hashing float momenta (values are small integers)


# ndarray -> tuple conversion caches.  Momentum vectors are numpy arrays
# reused across hundreds of thousands of id constructions but drawn from a
# small set of distinct values (loop-basis combinations), so a bytes-keyed
# memo turns the per-id conversion into one dict lookup.  Keyed on
# (dtype.str, bytes): dtype.str includes byte order, so a big-endian array
# aliasing a little-endian one's bytes cannot collide.  Size-capped (pure
# memo — clearing is always safe) so long-lived processes running many
# builds with different loop bases cannot grow them unboundedly.
_KTUP_CACHE: dict = {}
_MSYM_CACHE: dict = {}
_CACHE_CAP = 1 << 18


def _cache_put(cache: dict, key, value):
    if len(cache) >= _CACHE_CAP:
        cache.clear()
    cache[key] = value
    return value


def as_ktuple(k) -> Tuple[float, ...]:
    """Convert a momentum vector to a (cached) tuple of floats."""
    if isinstance(k, tuple):
        return k
    if isinstance(k, _np.ndarray):
        key = (k.dtype.str, k.tobytes())
        t = _KTUP_CACHE.get(key)
        if t is None:
            t = _cache_put(_KTUP_CACHE, key, tuple(k.tolist()))
        return t
    return tuple(float(x) for x in k)


def _mirror_of(k: Tuple[float, ...]) -> Tuple[float, ...]:
    for x in k:
        if x != 0:
            if x > 0:
                return k
            return tuple(0.0 if v == 0 else -v for v in k)
    return k


def mirror_symmetrize(k: Sequence[float]) -> Tuple[float, ...]:
    """Canonicalize the momentum sign: first nonzero entry positive
    (diagram_id.jl:81-96)."""
    if isinstance(k, _np.ndarray):
        key = (k.dtype.str, k.tobytes())
        t = _MSYM_CACHE.get(key)
        if t is None:
            t = _cache_put(_MSYM_CACHE, key, _mirror_of(tuple(k.tolist())))
        return t
    return _mirror_of(tuple(float(x) for x in k))


def _kapprox(a: Tuple[float, ...], b: Tuple[float, ...], rtol=1.49e-8) -> bool:
    if a == b:  # fast path: memoized tuples make exact equality the norm
        return True
    if len(a) != len(b):
        return False
    import math
    na = math.sqrt(sum(x * x for x in a))
    nb = math.sqrt(sum(x * x for x in b))
    diff = math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)))
    return diff <= rtol * max(na, nb)


def _khash(k: Tuple[float, ...]):
    return tuple(round(x, _ROUND) for x in k)


class DiagramId:
    """Abstract base of all diagram ids (diagram_id.jl:6)."""

    def __eq__(self, other):
        if type(self) is not type(other):
            return False
        return self._key_eq() == other._key_eq()

    def __hash__(self):
        # ids are immutable after construction; the optimizer's hash-consing
        # hashes every id many times, so cache the value per instance
        h = getattr(self, "_hash_cache", None)
        if h is None:
            h = hash((type(self).__name__,) + tuple(self._key_hash()))
            self._hash_cache = h
        return h

    def _key_eq(self):
        raise NotImplementedError

    def _key_hash(self):
        return self._key_eq()


class PropagatorId(DiagramId):
    """Abstract base of all bare propagators (diagram_id.jl:13)."""


class BareGreenId(PropagatorId):
    """Bare Green's function leaf (diagram_id.jl:19-33)."""

    __slots__ = ("type", "extK", "extT")

    def __init__(self, type: AnalyticProperty = Dynamic, *, k, t):
        self.type = AnalyticProperty(type)
        self.extK = mirror_symmetrize(k)
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.type, self.extT, self.extK)

    def _key_hash(self):
        return (self.type, self.extT, _khash(self.extK))

    def __repr__(self):
        return f"{short(self.type)}, k{list(self.extK)}, t{self.extT}"


class BareInteractionId(PropagatorId):
    """Bare interaction leaf with τ-symmetric equality (diagram_id.jl:35-69).

    Two ids are equal when response/type/extK match and either both are
    effectively time-local (extT[0] == extT[1]) or the extT tuples agree.
    """

    __slots__ = ("response", "type", "extK", "extT")

    def __init__(self, response: Response, type: AnalyticProperty = Instant, *, k, t=(0, 0)):
        self.response = Response(response)
        self.type = AnalyticProperty(type)
        self.extK = mirror_symmetrize(k)
        self.extT = tuple(t)

    def __eq__(self, other):
        if type(other) is not BareInteractionId:
            return False
        if (self.response != other.response or self.type != other.type
                or not _kapprox(self.extK, other.extK)):
            return False
        return ((self.extT[0] == self.extT[1] and other.extT[0] == other.extT[1])
                or self.extT == other.extT)

    def __hash__(self):
        h = getattr(self, "_hash_cache", None)
        if h is None:
            # time-local ids of any extT must collide; include extT otherwise
            tpart = "local" if self.extT[0] == self.extT[1] else self.extT
            h = hash(("BareInteractionId", self.response, self.type,
                      _khash(self.extK), tpart))
            self._hash_cache = h
        return h

    def __repr__(self):
        return f"{short(self.response)}{short(self.type)}, k{list(self.extK)}, t{self.extT}"


class GenericId(DiagramId):
    """Generic composite id (diagram_id.jl:71-79)."""

    __slots__ = ("para", "extra")

    def __init__(self, para, extra=None):
        self.para = para
        self.extra = extra

    def _key_eq(self):
        return (self.para, self.extra)

    def __repr__(self):
        return "" if self.extra is None else f"{self.extra}"


class GreenId(DiagramId):
    __slots__ = ("para", "type", "extK", "extT")

    def __init__(self, para, type: AnalyticProperty = Dynamic, *, k, t):
        self.para = para
        self.type = AnalyticProperty(type)
        self.extK = mirror_symmetrize(k)
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.type, self.extT, self.extK, self.para)

    def _key_hash(self):
        return (self.type, self.extT, _khash(self.extK), self.para)

    def __repr__(self):
        return f"{short(self.type)}, k{list(self.extK)}, t{self.extT}"


class SigmaId(DiagramId):
    __slots__ = ("para", "type", "extK", "extT")

    def __init__(self, para, type: AnalyticProperty, *, k, t=(0, 0)):
        self.para = para
        self.type = AnalyticProperty(type)
        self.extK = mirror_symmetrize(k)
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.type, self.extT, self.extK, self.para)

    def _key_hash(self):
        return (self.type, self.extT, _khash(self.extK), self.para)

    def __repr__(self):
        return f"{short(self.type)}, k{list(self.extK)}, t{self.extT}"


class PolarId(DiagramId):
    __slots__ = ("para", "response", "extK", "extT")

    def __init__(self, para, response: Response, *, k, t=(0, 0)):
        self.para = para
        self.response = Response(response)
        self.extK = mirror_symmetrize(k)
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.response, self.extT, self.extK, self.para)

    def _key_hash(self):
        return (self.response, self.extT, _khash(self.extK), self.para)

    def __repr__(self):
        return f"{short(self.response)}, k{list(self.extK)}, t{self.extT}"


class Ver3Id(DiagramId):
    __slots__ = ("para", "response", "extK", "extT")

    def __init__(self, para, response: Response, *, k, t=(0, 0, 0)):
        self.para = para
        self.response = Response(response)
        self.extK = tuple(map(as_ktuple, k))
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.response, self.extT, self.extK, self.para)

    def __repr__(self):
        return f"{short(self.response)}, t{self.extT}"


class Ver4Id(DiagramId):
    __slots__ = ("para", "response", "type", "channel", "extK", "extT")

    def __init__(self, para, response: Response, type: AnalyticProperty = Dynamic, *,
                 k, t=(0, 0, 0, 0), chan: TwoBodyChannel = AnyChan):
        self.para = para
        self.response = Response(response)
        self.type = AnalyticProperty(type)
        self.channel = TwoBodyChannel(chan)
        self.extK = tuple(map(as_ktuple, k))
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.response, self.type, self.channel, self.extT, self.extK, self.para)

    def __repr__(self):
        chan = "" if self.channel == AnyChan else f"{self.channel.name} "
        return f"{chan}{short(self.response)}{short(self.type)}, t{self.extT}"


# --- lattice / N-point ids (kept for SCE capability; diagram_id.jl:232-328)

class BareHoppingId(PropagatorId):
    """Hopping c⁺c⁻ between lattice sites."""

    __slots__ = ("para", "site", "orbital", "extT")

    def __init__(self, para, site: Tuple[int, int], orbital: Tuple[int, int],
                 t: Tuple[int, int]):
        self.para = para
        self.site = tuple(site)
        self.orbital = tuple(orbital)
        self.extT = tuple(t)

    def _key_eq(self):
        return (self.site, self.orbital, self.extT, self.para)


class BareGreenNId(PropagatorId):
    """Time-ordered N-point bare Green's function."""

    __slots__ = ("para", "site", "creation", "orbital", "extT", "N")

    def __init__(self, para, *, r=0, creation=(), orbital=(), t=()):
        if not (len(orbital) == len(t) == len(creation)):
            raise ValueError("orbital, t, creation must have equal length")
        self.para = para
        self.site = r
        self.creation = tuple(creation)
        self.orbital = tuple(orbital)
        self.extT = tuple(t)
        self.N = len(self.orbital)

    def _key_eq(self):
        return (self.N, self.site, self.creation, self.orbital, self.extT, self.para)


class GreenNId(DiagramId):
    __slots__ = ("para", "site", "creation", "orbital", "extT", "N")

    def __init__(self, para, *, r=(), creation=(), orbital=(), t=()):
        if not (len(orbital) == len(t) == len(r) == len(creation)):
            raise ValueError("r, orbital, t, creation must have equal length")
        self.para = para
        self.site = tuple(r)
        self.creation = tuple(creation)
        self.orbital = tuple(orbital)
        self.extT = tuple(t)
        self.N = len(self.orbital)

    def _key_eq(self):
        return (self.N, self.site, self.creation, self.orbital, self.extT, self.para)


class ConnectedGreenNId(GreenNId):
    pass


def index(id_type) -> int:
    """Leaf type code used by SoA leaf tables (diagram_id.jl:342-354)."""
    if id_type is BareGreenId:
        return 1
    if id_type is BareInteractionId:
        return 2
    if id_type is BareGreenNId:
        return 3
    if id_type is BareHoppingId:
        return 4
    raise ValueError(f"no leaf index for {id_type}")


def reconstruct(instance: DiagramId, **updates) -> DiagramId:
    """New instance of the same type with the given fields replaced
    (diagram_id.jl:364-384)."""
    cls = type(instance)
    fields = {}
    for slot in _all_slots(cls):
        fields[slot] = getattr(instance, slot)
    fields.update(updates)
    return _construct(cls, fields)


def _all_slots(cls):
    slots = []
    for klass in reversed(cls.__mro__):
        slots.extend(getattr(klass, "__slots__", ()))
    return slots


def _construct(cls, f):
    if cls is BareGreenId:
        return BareGreenId(f["type"], k=f["extK"], t=f["extT"])
    if cls is BareInteractionId:
        return BareInteractionId(f["response"], f["type"], k=f["extK"], t=f["extT"])
    if cls is GenericId:
        return GenericId(f["para"], f["extra"])
    if cls is GreenId:
        return GreenId(f["para"], f["type"], k=f["extK"], t=f["extT"])
    if cls is SigmaId:
        return SigmaId(f["para"], f["type"], k=f["extK"], t=f["extT"])
    if cls is PolarId:
        return PolarId(f["para"], f["response"], k=f["extK"], t=f["extT"])
    if cls is Ver3Id:
        return Ver3Id(f["para"], f["response"], k=f["extK"], t=f["extT"])
    if cls is Ver4Id:
        return Ver4Id(f["para"], f["response"], f["type"], chan=f["channel"],
                      k=f["extK"], t=f["extT"])
    if cls is BareHoppingId:
        return BareHoppingId(f["para"], f["site"], f["orbital"], f["extT"])
    if cls in (BareGreenNId,):
        return BareGreenNId(f["para"], r=f["site"], creation=f["creation"],
                            orbital=f["orbital"], t=f["extT"])
    if cls in (GreenNId, ConnectedGreenNId):
        return cls(f["para"], r=f["site"], creation=f["creation"],
                   orbital=f["orbital"], t=f["extT"])
    raise TypeError(f"cannot reconstruct {cls}")
