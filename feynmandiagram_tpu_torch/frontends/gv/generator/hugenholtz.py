"""Vacuum (lnZ) Hugenholtz diagram enumeration.

A labeled vacuum diagram of order n is a permutation p of the 2n G-slots:
slot i emits a propagator into slot p[i]; slots (2v, 2v+1) are the two
halves of interaction line v.  Two labeled diagrams are the same unlabeled
Hugenholtz diagram when related by the deformation group generated by
(reference diagram.py:208-259):

- direct<->exchange: swap the targets of slots (2v, 2v+1)
- half swap: exchange slot labels 2v <-> 2v+1 (as positions and values)
- interaction relabeling: swap slot pairs of interactions v and w

The class symmetry factor is fermi_sign(rep)/|Aut| with
|Aut| = |G| / |orbit|, |G| = 4^n n!.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, List, Sequence, Tuple

Perm = Tuple[int, ...]


def fermi_sign(perm: Perm) -> int:
    """(-1)^order * (-1)^{#fermion loops} for a vacuum permutation."""
    order = len(perm) // 2
    return (-1) ** order * (-1) ** len(find_loops(perm))


def find_loops(perm: Sequence[int]) -> List[List[int]]:
    """Fermion loops = cycles of the slot permutation (diagram.py:283-299)."""
    visited = set()
    loops = []
    for e in perm:
        loop = []
        v = e
        while v not in visited:
            loop.append(v)
            visited.add(v)
            v = perm[v]
        if loop:
            loops.append(loop)
    return loops


def is_connected(perm: Sequence[int], ext_num: int = 0) -> bool:
    """Connectivity over G-lines + interaction pairings (diagram.py:269-280).

    ``ext_num``: number of leading external slots (not paired by W-lines).
    """
    n = len(perm)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for i, t in enumerate(perm):
        union(i, t)
    for v in range((n - ext_num) // 2):
        union(ext_num + 2 * v, ext_num + 2 * v + 1)
    root = find(0)
    return all(find(i) == root for i in range(n))


def direct2exchange(perm: Perm, i: int, j: int) -> Perm:
    """Swap the targets of slots i and j (diagram.py:248-252)."""
    p = list(perm)
    p[i], p[j] = p[j], p[i]
    return tuple(p)


def swap_two_vertex(perm: Perm, i: int, j: int) -> Perm:
    """Exchange slot labels i <-> j as positions and values (diagram.py:221-229)."""
    p = list(perm)
    ip, jp = p.index(i), p.index(j)
    p[ip], p[jp] = j, i
    p[i], p[j] = p[j], p[i]
    return tuple(p)


def swap_two_interaction(perm: Perm, m: int, n: int, k: int, l: int) -> Perm:
    """Swap interaction (m,n) with interaction (k,l) (diagram.py:208-218)."""
    p = list(perm)
    mp, np_, kp, lp = p.index(m), p.index(n), p.index(k), p.index(l)
    p[mp], p[kp] = k, m
    p[np_], p[lp] = l, n
    p[m], p[k] = p[k], p[m]
    p[n], p[l] = p[l], p[n]
    return tuple(p)


def _orbit(perm: Perm, order: int, first_vertex: int = 0,
           ext_num: int = 0) -> set:
    """BFS orbit of ``perm`` under the deformation group acting on
    interactions ``first_vertex..order-1`` (slots shifted by ext_num)."""
    seen = {perm}
    frontier = [perm]
    while frontier:
        new = []
        for p in frontier:
            for v in range(first_vertex, order):
                a, b = ext_num + 2 * v, ext_num + 2 * v + 1
                for q in (direct2exchange(p, a, b), swap_two_vertex(p, a, b)):
                    if q not in seen:
                        seen.add(q)
                        new.append(q)
            for v in range(first_vertex, order):
                for w in range(first_vertex, v):
                    q = swap_two_interaction(p, ext_num + 2 * v, ext_num + 2 * v + 1,
                                             ext_num + 2 * w, ext_num + 2 * w + 1)
                    if q not in seen:
                        seen.add(q)
                        new.append(q)
        frontier = new
    return seen


def _connected_vacuum_perms(order: int) -> Iterator[Perm]:
    """All connected vacuum slot permutations of the given order.

    Enumerated vertex-targets-first to prune disconnected configurations
    early (full slot enumeration is (2n)!).
    """
    n2 = 2 * order
    for perm in itertools.permutations(range(n2)):
        if is_connected(perm):
            yield perm


def lnz_classes(order: int, progress=None) -> List[Tuple[Perm, float]]:
    """Unlabeled lnZ Hugenholtz classes: [(representative, sym_factor)].

    sym_factor = fermi_sign(rep) / |Aut|.  Replaces the reference seeds
    (Diagram/HugenDiag{order}.diag) + free_energy.LoadDiagrams/
    OptimizeLoopBasis.
    """
    group_size = 4 ** order * math.factorial(order)
    classes: List[Tuple[Perm, float]] = []
    visited = set()
    count = 0
    for perm in _connected_vacuum_perms(order):
        if perm in visited:
            continue
        orbit = _orbit(perm, order)
        visited |= orbit
        aut = group_size // len(orbit)
        if group_size % len(orbit) != 0:
            raise AssertionError("orbit size must divide the group size")
        classes.append((perm, fermi_sign(perm) / aut))
        count += 1
        if progress is not None:
            progress(count, len(visited))
    return classes
