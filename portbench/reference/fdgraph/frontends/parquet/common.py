"""Parquet bookkeeping: dispatcher, loop/τ-slot accounting, partitions.

Reference: FeynmanDiagram.jl/src/frontend/parquet/common.jl.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Sequence, Tuple

import numpy as np

from . import (DiagPara, DiagramType, Ver4Diag, SigmaDiag, PolarDiag, Ver3Diag,
               GreenDiag, VacuumDiag, inner_tau_num, first_tau_idx, first_loop_idx)
from ..common import PHr, PHEr, PPr, Alli


def build(para: DiagPara, extK=None, subdiagram: bool = False, *,
          channels=(PHr, PHEr, PPr, Alli)):
    """Dispatch on para.type (common.jl:2-26)."""
    from .vertex4 import vertex4
    from .sigma import sigma
    from .polarization import polarization
    from .vertex3 import vertex3

    if para.type == Ver4Diag:
        if extK is None:
            extK = [get_k(para.totalLoopNum, 1), get_k(para.totalLoopNum, 2),
                    get_k(para.totalLoopNum, 3)]
        return vertex4(para, extK, subdiagram, channels=channels)
    if para.type == SigmaDiag:
        if extK is None:
            extK = get_k(para.totalLoopNum, 1)
        return sigma(para, extK, subdiagram)
    if para.type == PolarDiag:
        if extK is None:
            extK = get_k(para.totalLoopNum, 1)
        return polarization(para, extK, subdiagram)
    if para.type == Ver3Diag:
        if extK is None:
            extK = [get_k(para.totalLoopNum, 1), get_k(para.totalLoopNum, 2)]
        return vertex3(para, extK, subdiagram, channels=channels)
    raise ValueError(f"build not implemented for {para.type}")


def ordered_partition(total: int, n: int, lowerbound: int = 1) -> List[List[int]]:
    """All ordered n-way partitions of ``total`` with parts >= lowerbound
    (common.jl:28-45).  e.g. (5, 2) -> [[4,1],[1,4],[3,2],[2,3]].

    Results are memoized (the recursion re-asks the same partitions at every
    vertex of the parquet tree); the returned lists are fresh copies."""
    return [list(p) for p in _ordered_partition_cached(total, n, lowerbound)]


@functools.lru_cache(maxsize=None)
def _ordered_partition_cached(total, n, lowerbound):
    if lowerbound < 0:
        raise ValueError("lowerbound must be >= 0")
    shifted = total - n * (lowerbound - 1)
    if shifted < n:
        raise ValueError(f"no partition of {total} into {n} parts >= {lowerbound}")
    result = []
    seen = set()

    def partitions(m, k, maxpart):
        # integer partitions of m into exactly k parts each >= 1, descending
        if k == 1:
            if 1 <= m <= maxpart:
                yield [m]
            return
        for first in range(min(m - k + 1, maxpart), 0, -1):
            for rest in partitions(m - first, k - 1, first):
                yield [first] + rest

    for p in partitions(shifted, n, shifted):
        p = [x + lowerbound - 1 for x in p]
        for perm in set(itertools.permutations(p)):
            if perm not in seen:
                seen.add(perm)
                result.append(perm)
    return tuple(result)


def get_k(loop_num: int, loop_idx: int) -> np.ndarray:
    """Unit momentum-basis vector with 1 at 1-based ``loop_idx`` (common.jl:135-139)."""
    k = np.zeros(loop_num)
    k[loop_idx - 1] = 1.0
    return k


def find_first_loop_idx(partition: Sequence[int], firstidx: int) -> Tuple[List[int], int]:
    """First loop index per sub-problem given its loop counts (common.jl:142-152).

    e.g. partition=[1,1,2,1], firstidx=1 -> ([1,2,3,5], 5)
    """
    acc = firstidx
    first = []
    for p in partition:
        first.append(acc)
        acc += p
    return first, acc - 1


def find_first_tau_idx(partition: Sequence[int], types: Sequence[DiagramType],
                       firstidx: int, tau_num: int) -> Tuple[List[int], int]:
    """First tau index per sub-problem (common.jl:154-167).

    n-loop G consumes n*tau_num slots; n-loop ver4 consumes (n+1)*tau_num.
    """
    if len(partition) != len(types):
        raise ValueError("partition and types must have equal length")
    acc = firstidx
    first = []
    for p, t in zip(partition, types):
        first.append(acc)
        acc += inner_tau_num(t, p, tau_num)
    return first, acc - 1


def total_tau_num(dtype: DiagramType, inner_loop_num: int, interaction_tau: int,
                  offset: int = 0) -> int:
    return first_tau_idx(dtype, offset) + inner_tau_num(dtype, inner_loop_num, interaction_tau) - 1


def total_loop_num(dtype: DiagramType, inner_loop_num: int, offset: int = 0) -> int:
    return first_loop_idx(dtype, offset) + inner_loop_num - 1
