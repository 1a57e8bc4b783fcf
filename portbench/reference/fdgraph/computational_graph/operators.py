"""Node operators for the computational-graph IR.

The IR supports four node operations, mirroring the reference semantics
(FeynmanDiagram.jl/src/computational_graph/abstractgraph.jl:3-42):

- ``SUM``     : node = sum_i factor_i * child_i
- ``PROD``    : node = prod_i (factor_i * child_i)
- ``POWER``   : node = factor_1 * child_1 ** n   (exactly one child; n != 0, 1)
- ``UNITARY`` : constant node (no children); weight fixed at construction

Operators are represented as an ``Op`` value object so that ``Power(n)``
carries its exponent.  ``unary_istrivial`` / ``isassociative`` reproduce the
reference operator traits.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Op:
    kind: str  # 'sum' | 'prod' | 'power' | 'unitary'
    n: int = 0  # exponent, only meaningful for kind == 'power'

    def __repr__(self) -> str:
        if self.kind == "power":
            return f"Power({self.n})"
        return self.kind.capitalize()


SUM = Op("sum")
PROD = Op("prod")
UNITARY = Op("unitary")


def Power(n: int) -> Op:
    """Power operator with integer exponent ``n`` (n not in {0, 1})."""
    if n in (0, 1):
        raise ValueError(f"Power({n}) makes no sense.")
    return Op("power", n)


def decrement_power(op: Op) -> Op:
    """Power{N} -> Power{N-1}; Power{2} -> Sum (a trivial unary wrapper).

    Reference: abstractgraph.jl:14.
    """
    if op.kind != "power":
        raise ValueError(f"decrement_power expects a Power operator, got {op}")
    return SUM if op.n == 2 else Power(op.n - 1)


def unary_istrivial(op: Op) -> bool:
    """Is the unary form of the operator trivial: O(g) == g?

    True for Sum and Prod ((+g) == g and (*g) == g); implies the subgraph
    factor can be hoisted into the parent.  Reference: abstractgraph.jl:31-35.
    """
    return op.kind in ("sum", "prod")


def isassociative(op: Op) -> bool:
    """Reference: abstractgraph.jl:37-42 (only Sum is declared associative)."""
    return op.kind == "sum"
