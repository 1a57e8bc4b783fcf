"""Multivariate truncated Taylor series with graph-valued coefficients.

A copy of ``feynmandiagram_tpu/taylor`` with unchanged behaviour.
Reference: FeynmanDiagram.jl/src/TaylorSeries/.  The coefficient type is
anything supporting +, scalar *, and * (Graphs in production); the global
variable registry mirrors the reference ``set_variables`` API.  The
registry is this module's own: the JAX package's copy keeps another, so
the two packages never see each other's variables.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


class _TaylorParams:
    def __init__(self, orders: List[int], names: List[str]):
        self.orders = orders
        self.num_vars = len(orders)
        self.variable_names = names


# The variable registry mirrors the reference's global ParamsTaylor
# (parameter.jl:26) but is thread-local, and ``taylor_context`` scopes any
# change with save/restore, so interleaved builds cannot corrupt each other
# (SURVEY §5.2).
_tls = threading.local()


def _params_get() -> _TaylorParams:
    p = getattr(_tls, "params", None)
    if p is None:
        p = _TaylorParams([2, 2], ["x1", "x2"])
        _tls.params = p
    return p


def get_orders(idx: Optional[int] = None):
    """Maximum truncation order(s); ``idx`` is 0-based (parameter.jl:29-30)."""
    if idx is None:
        return list(_params_get().orders)
    return _params_get().orders[idx]


def get_numvars() -> int:
    return _params_get().num_vars


def get_variable_names() -> List[str]:
    return list(_params_get().variable_names)


def set_variables(names, *, orders=None, numvars: int = -1):
    """Register the AD variables and their truncation orders; returns the
    corresponding first-order TaylorSeries list (parameter.jl:61-108)."""
    if isinstance(names, str):
        names = names.split()
    names = [str(n) for n in names]
    if len(names) == 1 and numvars > 1:
        names = [f"{names[0]}{i + 1}" for i in range(numvars)]
    if orders is None:
        orders = get_orders()
    if len(orders) != len(names):
        raise ValueError("orders must have the same length as the variable names")
    _tls.params = _TaylorParams(list(orders), names)
    return [TaylorSeries.variable(i) for i in range(get_numvars())]


@contextlib.contextmanager
def taylor_context(names=None, *, orders=None):
    """Scope a variable registry: the previous registry is restored on exit,
    so a library call can expand with its own variables without clobbering
    the caller's.  ``taylorAD`` uses this internally."""
    saved = getattr(_tls, "params", None)
    try:
        if names is not None:
            yield set_variables(names, orders=orders)
        else:
            yield
    finally:
        _tls.params = saved


class TaylorSeries:
    """coeffs: dict mapping order-vectors (as tuples) to coefficients
    (constructors.jl:10-21)."""

    __slots__ = ("name", "coeffs")

    def __init__(self, coeffs: Optional[Dict[Tuple[int, ...], object]] = None,
                 name: str = ""):
        self.name = name
        self.coeffs: Dict[Tuple[int, ...], object] = dict(coeffs or {})

    @staticmethod
    def variable(nv: int, one_value=1.0) -> "TaylorSeries":
        """The series t = x_nv (0-based index)."""
        if not (0 <= nv < get_numvars()):
            raise ValueError("variable index out of range")
        v = [0] * get_numvars()
        v[nv] = 1
        return TaylorSeries({tuple(v): one_value})

    def copy(self) -> "TaylorSeries":
        return TaylorSeries(dict(self.coeffs), self.name)

    # -- arithmetic (arithmetic.jl) ------------------------------------
    def __mul__(self, other):
        if isinstance(other, TaylorSeries):
            return self._mul_series(other)
        g = TaylorSeries()
        for order, coeff in self.coeffs.items():
            g.coeffs[order] = coeff * other
        return g

    def __rmul__(self, c):
        g = TaylorSeries()
        for order, coeff in self.coeffs.items():
            g.coeffs[order] = c * coeff
        return g

    def __add__(self, other):
        if not isinstance(other, TaylorSeries):
            return self._add_const(other)
        g = TaylorSeries()
        g.coeffs = dict(self.coeffs)
        for order, coeff in other.coeffs.items():
            if order in g.coeffs:
                g.coeffs[order] = g.coeffs[order] + coeff
            else:
                g.coeffs[order] = coeff
        return g

    def __radd__(self, c):
        return self._add_const(c)

    def _add_const(self, c):
        g = TaylorSeries()
        g.coeffs = dict(self.coeffs)
        zero_order = tuple([0] * get_numvars())
        if zero_order in g.coeffs:
            g.coeffs[zero_order] = g.coeffs[zero_order] + c
        else:
            g.coeffs[zero_order] = c
        return g

    def __sub__(self, other):
        if isinstance(other, TaylorSeries):
            return self + (-1 * other)
        return self + (-other)

    def __rsub__(self, c):
        return c + (-1 * self)

    def _mul_series(self, other: "TaylorSeries") -> "TaylorSeries":
        """Truncated product: drop orders beyond the per-variable caps
        (arithmetic.jl:170-191)."""
        caps = get_orders()
        g = TaylorSeries()
        for o1, c1 in self.coeffs.items():
            for o2, c2 in other.coeffs.items():
                order = tuple(a + b for a, b in zip(o1, o2))
                if all(o <= cap for o, cap in zip(order, caps)):
                    term = c1 * c2
                    if order in g.coeffs:
                        g.coeffs[order] = g.coeffs[order] + term
                    else:
                        g.coeffs[order] = term
        return g

    def __pow__(self, p: int) -> "TaylorSeries":
        """Power by squaring (arithmetic.jl:282-317)."""
        if p < 0:
            raise ValueError("negative powers of Taylor series are not supported")
        if p == 1:
            return self.copy()
        if p == 0:
            return one_series()
        result = None
        base = self
        n = p
        while n > 0:
            if n & 1:
                result = base if result is None else result * base
            n >>= 1
            if n:
                base = base * base
        return result

    def get_coeff(self, order: Sequence[int]):
        return self.coeffs.get(tuple(order))

    def get_derivative(self, order: Sequence[int]):
        c = self.coeffs.get(tuple(order))
        if c is None:
            return None
        return taylor_factorial(order) * c

    def __repr__(self):
        terms = ", ".join(f"{order}: {coeff}" for order, coeff in sorted(self.coeffs.items()))
        return f"TaylorSeries({terms})"

    def __str__(self):
        return pretty_print(self)


# API-compatible aliases for the reference names
getcoeff = TaylorSeries.get_coeff
getderivative = TaylorSeries.get_derivative


def one_series(one_value=1.0) -> TaylorSeries:
    return TaylorSeries({tuple([0] * get_numvars()): one_value})


def taylor_binomial(o1: Sequence[int], o2: Sequence[int]) -> int:
    """Binomial prefactor for products of derivatives (arithmetic.jl:132-142)."""
    if len(o1) != len(o2):
        raise ValueError("order vectors must have equal length")
    result = 1
    for a, b in zip(o1, o2):
        if a + b:
            result *= math.comb(a + b, a)
    return result


def taylor_factorial(o: Sequence[int]) -> int:
    """Product of factorials of the order vector (arithmetic.jl:146-159)."""
    result = 1
    for a in o:
        result *= math.factorial(a)
    return result


# ---------------------------------------------------------------------------
# display (print.jl): monomials with superscript powers; numeric coefficients
# printed sign-aware, Graph coefficients as g<id>
# ---------------------------------------------------------------------------

_SUPERSCRIPTS = "⁰¹²³⁴⁵⁶⁷⁸⁹"


def _superscriptify(n: int) -> str:
    return "".join(_SUPERSCRIPTS[int(d)] for d in str(n))


def _monomial(order: Sequence[int]) -> str:
    names = get_variable_names()
    out = ""
    for i, p in enumerate(order):
        if p == 1:
            out += f" {names[i]}"
        elif p > 1:
            out += f" {names[i]}{_superscriptify(p)}"
    return out


def pretty_print(series: TaylorSeries, big_o: bool = True) -> str:
    """Human-readable polynomial form, e.g. `1.0 + 2.0 x y² + 𝒪(x³y³)`
    (print.jl:126-199).  Graph-valued coefficients render as g<id>."""
    parts: List[str] = []
    for order in sorted(series.coeffs):
        coeff = series.coeffs[order]
        if isinstance(coeff, (int, float)):
            if coeff == 0:
                continue
            sign = "- " if coeff < 0 else ("+ " if parts else "")
            text = f"{sign}{abs(coeff)}"
        elif isinstance(coeff, complex):
            text = ("+ " if parts else "") + f"( {coeff} )"
        else:  # graph-valued
            text = ("+ " if parts else "") + f"g{coeff.id}"
        parts.append(text + _monomial(order))
    body = " ".join(parts) if parts else "0"
    if big_o:
        names = get_variable_names()
        tail = "".join(f"{names[i]}{_superscriptify(o + 1)}"
                       for i, o in enumerate(get_orders()))
        return f"{body} + 𝒪({tail})"
    return body
