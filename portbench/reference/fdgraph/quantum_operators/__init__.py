"""Algebra of creation/annihilation operators with statistics bookkeeping.

Reference: FeynmanDiagram.jl/src/quantum_operator/ (operator.jl, expression.jl).
Provides QuantumOperator, OperatorProduct, normal/correlator ordering with
fermionic permutation parity — the sign engine behind ``feynman_diagram``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple, Union

# operator kind codes
FERMI_CREATION = "f+"
FERMI_ANNIHILATION = "f-"
MAJORANA = "f"
BOSON_CREATION = "b+"
BOSON_ANNIHILATION = "b-"
CLASSIC = "phi"

_ADJOINT = {
    FERMI_CREATION: FERMI_ANNIHILATION,
    FERMI_ANNIHILATION: FERMI_CREATION,
    MAJORANA: MAJORANA,
    BOSON_CREATION: BOSON_ANNIHILATION,
    BOSON_ANNIHILATION: BOSON_CREATION,
    CLASSIC: CLASSIC,
}
_FERMIONIC = {FERMI_CREATION, FERMI_ANNIHILATION, MAJORANA}
_CREATION = {FERMI_CREATION, BOSON_CREATION}
_ANNIHILATION = {FERMI_ANNIHILATION, BOSON_ANNIHILATION}


@dataclass(frozen=True)
class QuantumOperator:
    """A single quantum operator with an integer label (operator.jl:62-69)."""
    operator: str
    label: int

    def __post_init__(self):
        if self.operator not in _ADJOINT:
            raise ValueError(f"unknown operator kind {self.operator}")
        if self.label < 0:
            raise ValueError("label must be >= 0")

    def adjoint(self) -> "QuantumOperator":
        return QuantumOperator(_ADJOINT[self.operator], self.label)

    def isfermionic(self) -> bool:
        return self.operator in _FERMIONIC

    def iscreation(self) -> bool:
        return self.operator in _CREATION

    def isannihilation(self) -> bool:
        return self.operator in _ANNIHILATION

    def __repr__(self) -> str:
        sym = {FERMI_CREATION: "f⁺", FERMI_ANNIHILATION: "f⁻", MAJORANA: "f",
               BOSON_CREATION: "b⁺", BOSON_ANNIHILATION: "b⁻", CLASSIC: "ϕ"}[self.operator]
        return f"{sym}({self.label})"


class OperatorProduct:
    """An ordered product of quantum operators (expression.jl:10-26)."""

    __slots__ = ("operators",)

    def __init__(self, operators: Union[QuantumOperator, "OperatorProduct",
                                        Iterable] = ()):
        if isinstance(operators, QuantumOperator):
            self.operators: List[QuantumOperator] = [operators]
        elif isinstance(operators, OperatorProduct):
            self.operators = list(operators.operators)
        else:
            ops: List[QuantumOperator] = []
            for o in operators:
                if isinstance(o, OperatorProduct):
                    ops.extend(o.operators)
                else:
                    ops.append(o)
            self.operators = ops

    def __len__(self) -> int:
        return len(self.operators)

    def __iter__(self) -> Iterator[QuantumOperator]:
        return iter(self.operators)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return OperatorProduct(self.operators[i])
        return self.operators[i]

    def __setitem__(self, i, v):
        self.operators[i] = v

    def __eq__(self, other) -> bool:
        if isinstance(other, OperatorProduct):
            return self.operators == other.operators
        if isinstance(other, (list, tuple)):
            return self.operators == list(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple(self.operators))

    def __mul__(self, other):
        if isinstance(other, OperatorProduct):
            return OperatorProduct(self.operators + other.operators)
        if isinstance(other, QuantumOperator):
            return OperatorProduct(self.operators + [other])
        return NotImplemented

    def adjoint(self) -> "OperatorProduct":
        return OperatorProduct([op.adjoint() for op in reversed(self.operators)])

    def isfermionic(self) -> bool:
        return sum(1 for op in self if op.isfermionic()) % 2 == 1

    def __repr__(self) -> str:
        return "".join(repr(o) for o in self.operators)


# abbreviated constructors (expression.jl:41-52)
def fermionic_annihilation(i: int) -> OperatorProduct:
    return OperatorProduct(QuantumOperator(FERMI_ANNIHILATION, i))


def fermionic_creation(i: int) -> OperatorProduct:
    return OperatorProduct(QuantumOperator(FERMI_CREATION, i))


def majorana(i: int) -> OperatorProduct:
    return OperatorProduct(QuantumOperator(MAJORANA, i))


def bosonic_annihilation(i: int) -> OperatorProduct:
    return OperatorProduct(QuantumOperator(BOSON_ANNIHILATION, i))


def bosonic_creation(i: int) -> OperatorProduct:
    return OperatorProduct(QuantumOperator(BOSON_CREATION, i))


def real_classic(i: int) -> OperatorProduct:
    return OperatorProduct(QuantumOperator(CLASSIC, i))


# unicode aliases matching the reference exports
fm = f_minus = fermionic_annihilation
fp = f_plus = fermionic_creation
fmaj = majorana
bm = b_minus = bosonic_annihilation
bp = b_plus = bosonic_creation
phi = real_classic


def parity(p: Sequence[int]) -> int:
    """Permutation parity via cycle-swap counting (expression.jl:194-205).

    ``p`` is 0-based here (a permutation of 0..n-1).
    """
    count = 0
    p_swap = list(p)
    for i in range(len(p_swap)):
        while p_swap[i] != i:
            count += 1
            j = p_swap[i]
            p_swap[i], p_swap[j] = p_swap[j], p_swap[i]
    return 1 if count % 2 == 0 else -1


def _sortperm(v: Sequence) -> List[int]:
    return sorted(range(len(v)), key=lambda i: v[i])


def _ordering_to_sign_perm(operator: OperatorProduct, ordering: List[int]) -> Tuple[int, List[int]]:
    fermionic_positions = [ordering[i] for i, op in enumerate(operator) if op.isfermionic()]
    sign = 1 if not fermionic_positions else parity(_sortperm(fermionic_positions))
    return sign, _sortperm(ordering)


def normal_order(operator: OperatorProduct) -> Tuple[int, List[int]]:
    """Permutation converting to normal order (creators left); returns
    (fermionic sign, permutation).  Reference: expression.jl:121-150.
    """
    num = len(operator)
    ind_pair, ind_unpair = 0, num + 1
    ordering: List[int] = []
    ops = list(operator)
    for i, op in enumerate(ops):
        adj = op.adjoint()
        if adj in ops[i + 1:]:
            ind_pair += 1
            ordering.append(ind_pair if not op.isannihilation() else num + 1 - ind_pair)
        elif adj in ops[:i]:
            last = max(j for j in range(i) if ops[j] == adj)
            ordering.append(num + 1 - ordering[last])
        else:
            ordering.append(ind_unpair if not op.isannihilation() else -ind_unpair)
    ind_ann, ind_cre = 0, 0
    for i, value in enumerate(ordering):
        if value == ind_unpair:
            ind_cre += 1
            ordering[i] = ind_pair + ind_cre
        elif value == -ind_unpair:
            ind_ann += 1
            ordering[i] = num + 1 - ind_pair - ind_ann
    return _ordering_to_sign_perm(operator, ordering)


def correlator_order(operator: OperatorProduct) -> Tuple[int, List[int]]:
    """Permutation converting to correlator order (annihilators left);
    returns (fermionic sign, permutation).  Reference: expression.jl:159-188.
    """
    num = len(operator)
    ind_pair, ind_unpair = 0, num + 1
    ordering: List[int] = []
    ops = list(operator)
    for i, op in enumerate(ops):
        adj = op.adjoint()
        if adj in ops[i + 1:]:
            ind_pair += 1
            ordering.append(ind_pair if not op.iscreation() else num + 1 - ind_pair)
        elif adj in ops[:i]:
            last = max(j for j in range(i) if ops[j] == adj)
            ordering.append(num + 1 - ordering[last])
        else:
            ordering.append(ind_unpair if not op.iscreation() else -ind_unpair)
    ind_ann, ind_cre = 0, 0
    for i, value in enumerate(ordering):
        if value == ind_unpair:
            ind_ann += 1
            ordering[i] = ind_pair + ind_ann
        elif value == -ind_unpair:
            ind_cre += 1
            ordering[i] = num + 1 - ind_pair - ind_cre
    return _ordering_to_sign_perm(operator, ordering)
