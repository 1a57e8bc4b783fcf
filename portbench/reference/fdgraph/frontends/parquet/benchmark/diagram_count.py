"""Exact diagram-count formulas (arXiv:cond-mat/0512342).

Assumes a spin-symmetric interaction and spin-conserving propagators.
Reference: FeynmanDiagram.jl/src/frontend/parquet/benchmark/diagram_count.jl.
"""
from __future__ import annotations


def count_ver3_g2v(inner_loop_num: int, spin: int) -> int:
    if inner_loop_num < 0:
        raise ValueError("inner_loop_num must be >= 0")
    table = {0: 1, 1: 1, 2: 3 * (2 + spin), 3: 5 * (10 + 9 * spin + spin ** 2)}
    if inner_loop_num not in table:
        raise NotImplementedError(f"order {inner_loop_num}")
    return table[inner_loop_num]


def count_ver3_G2v(inner_loop_num: int, spin: int) -> int:
    if inner_loop_num < 0:
        raise ValueError("inner_loop_num must be >= 0")
    table = {0: 1, 1: 1, 2: 4 + 3 * spin, 3: 27 + 31 * spin + 5 * spin ** 2}
    if inner_loop_num not in table:
        raise NotImplementedError(f"order {inner_loop_num}")
    return table[inner_loop_num]


def count_ver3_G2W(inner_loop_num: int, spin: int) -> int:
    if inner_loop_num < 0:
        raise ValueError("inner_loop_num must be >= 0")
    table = {0: 1, 1: 1, 2: 4 + 2 * spin, 3: 27 + 22 * spin}
    if inner_loop_num not in table:
        raise NotImplementedError(f"order {inner_loop_num}")
    return table[inner_loop_num]


def count_sigma_G2v(inner_loop_num: int, spin: int) -> int:
    if inner_loop_num < 1:
        raise ValueError("inner_loop_num must be >= 1")
    table = {1: 1, 2: 1 + spin, 3: 4 + 5 * spin + spin ** 2,
             4: 27 + 40 * spin + 14 * spin ** 2 + spin ** 3}
    if inner_loop_num not in table:
        raise NotImplementedError(f"order {inner_loop_num}")
    return table[inner_loop_num]


def count_sigma_G2W(inner_loop_num: int, spin: int) -> int:
    if inner_loop_num < 1:
        raise ValueError("inner_loop_num must be >= 1")
    return count_ver3_G2W(inner_loop_num, spin)


def count_polar_G2v(inner_loop_num: int, spin: int) -> int:
    if inner_loop_num < 1:
        raise ValueError("inner_loop_num must be >= 1")
    return spin * count_ver3_G2v(inner_loop_num - 1, spin)


def count_polar_G2W(inner_loop_num: int, spin: int) -> int:
    return spin * count_ver3_G2W(inner_loop_num - 1, spin)


def count_polar_g2v_noFock_upup(inner_loop_num: int, spin: int) -> int:
    """Polarization diagrams for <n↑ n↑> with bare g, bare v, no Fock."""
    if spin != 2:
        raise NotImplementedError("only spin=2 has been implemented!")
    table = {1: 2, 2: 2, 3: 28, 4: 274, 5: 3586}
    if inner_loop_num not in table:
        raise NotImplementedError(f"order {inner_loop_num}")
    return table[inner_loop_num]


def count_polar_g2v_noFock_updown(inner_loop_num: int, spin: int) -> int:
    """Polarization diagrams for <n↑ n↓> with bare g, bare v, no Fock."""
    if spin != 2:
        raise NotImplementedError("only spin=2 has been implemented!")
    table = {1: 0, 2: 0, 3: 4, 4: 52, 5: 844}
    if inner_loop_num not in table:
        raise NotImplementedError(f"order {inner_loop_num}")
    return table[inner_loop_num]


def count_polar_g2v_noFock(inner_loop_num: int, spin: int) -> int:
    return (count_polar_g2v_noFock_upup(inner_loop_num, spin)
            + count_polar_g2v_noFock_updown(inner_loop_num, spin))
