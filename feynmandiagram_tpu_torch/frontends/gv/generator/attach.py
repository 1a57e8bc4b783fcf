"""Attach external vertices to lnZ diagrams and group equivalent topologies.

Port of the algorithm of the reference polar.py:40-176: the two external
vertices (slots 0, 1) are spliced into a G-line of the (slot-shifted) lnZ
diagram, then slid along all fermion lines by a BFS that keeps the integer
loop basis consistent at every step; finally, diagrams related by the
deformation group of the internal interactions merge, multiplying the
symmetry factor by the class size.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hugenholtz import (direct2exchange, is_connected, swap_two_interaction,
                         swap_two_vertex)

Perm = Tuple[int, ...]
SHIFT = 2  # external slots 0 and 1


def _mirror(i: int) -> int:
    return i + 1 if i % 2 == 0 else i - 1


def vacuum_loop_basis(perm: Sequence[int]) -> np.ndarray:
    """Integer fundamental-cycle loop basis [loop_num x g_num] for a vacuum
    permutation; momentum of G-line i is basis[:, i] . loop_momenta.

    Vertex-level conservation: sum of outgoing G equals sum of incoming G at
    every interaction vertex, so valid assignments are flows on the
    contracted multigraph (n vertices, 2n G-edges); a spanning-tree cycle
    basis yields loop_num = n + 1 independent +-1 flows.
    """
    g_num = len(perm)
    n = g_num // 2
    # multigraph edges: G-line i goes vertex i//2 -> perm[i]//2
    edges = [(i // 2, perm[i] // 2) for i in range(g_num)]
    # spanning tree (undirected) via BFS
    adj: Dict[int, List[Tuple[int, int]]] = {v: [] for v in range(n)}
    for ei, (a, b) in enumerate(edges):
        adj[a].append((b, ei))
        adj[b].append((a, ei))
    parent_edge = {0: None}
    order_bfs = [0]
    for v in order_bfs:
        for w, ei in adj[v]:
            if w not in parent_edge:
                parent_edge[w] = (v, ei)
                order_bfs.append(w)
    if len(parent_edge) != n:
        raise ValueError("vacuum diagram is not connected")
    tree_edges = {info[1] for info in parent_edge.values() if info is not None}

    def path_to_root(v):
        out = []
        while parent_edge[v] is not None:
            p, ei = parent_edge[v]
            out.append((v, p, ei))
            v = p
        return out

    basis_rows = []
    for ei, (a, b) in enumerate(edges):
        if ei in tree_edges:
            continue
        row = np.zeros(g_num, dtype=int)
        row[ei] += 1  # chord a -> b
        # close the cycle: walk b -> root -> a along the tree
        pa = path_to_root(a)
        pb = path_to_root(b)
        # strip the common suffix (paths share the tail to the root)
        while pa and pb and pa[-1][2] == pb[-1][2]:
            pa.pop()
            pb.pop()
        for v, p, tei in pb:  # b up to the meeting point: follow edge direction
            ta, tb = edges[tei]
            row[tei] += 1 if (ta, tb) == (v, p) else -1
        for v, p, tei in pa:  # meeting point down to a: reversed
            ta, tb = edges[tei]
            row[tei] += -1 if (ta, tb) == (v, p) else 1
        basis_rows.append(row)
    basis = np.asarray(basis_rows, dtype=int)
    if basis.shape[0] != n + 1:
        raise AssertionError("cycle rank must be n + 1")
    check_conservation(perm, basis, [(2 * v, 2 * v + 1) for v in range(n)])
    return basis


def check_conservation(perm: Sequence[int], basis: np.ndarray,
                       interaction_pairs) -> None:
    """Random-vector conservation check (diagram.py:302-328)."""
    if np.linalg.matrix_rank(basis.astype(float)) != basis.shape[0]:
        raise AssertionError("loop basis is rank deficient")
    rng = np.random.default_rng(0)
    mom = rng.random(basis.shape[0]) @ basis.astype(float)
    perm = list(perm)
    for in1, in2 in interaction_pairs:
        out1, out2 = perm.index(in1), perm.index(in2)
        if abs(mom[in1] + mom[in2] - mom[out1] - mom[out2]) > 1e-9:
            raise AssertionError("momentum not conserved")


def attach_external_vertices(lnz_perm: Perm, lnz_basis: np.ndarray,
                             sym_factor: float
                             ) -> Dict[Perm, Tuple[np.ndarray, float]]:
    """All labeled polarization-type diagrams obtained by inserting external
    slots 0 and 1 into the lnZ diagram (polar.py:40-129).

    Returns {permutation: (loop_basis, sym_factor)}; loop index 0 is the
    external momentum.
    """
    order = len(lnz_perm) // 2 + 1
    g_num = 2 * order
    loop_num = order + 1
    diag = [e + SHIFT for e in lnz_perm]
    interaction_pairs = [(2 * i, 2 * i + 1) for i in range(1, order)]
    out: Dict[Perm, Tuple[np.ndarray, float]] = {}

    for i in range(SHIFT, len(diag) + SHIFT):
        # splice: d[i] <== 1 <== 0 <== i
        d = [0, 1] + list(diag)
        d[1] = d[i]
        d[0] = 1
        d[i] = 0
        momentum = np.zeros((loop_num, g_num), dtype=int)
        momentum[1:, 2:] = lnz_basis
        momentum[1:, 0] = lnz_basis[:, i - SHIFT]
        momentum[1:, 1] = lnz_basis[:, i - SHIFT]
        momentum[0, 0] = 1
        check_conservation(d, momentum, interaction_pairs)

        out[tuple(d)] = (momentum, sym_factor)
        to_visit = [d[1], _mirror(d[1])]
        start_perm = [tuple(d), tuple(d)]
        start_mom = [momentum, momentum]
        visited = [0]
        while to_visit:
            index = to_visit.pop()
            perm = list(start_perm.pop())
            mom = np.copy(start_mom.pop())
            if index in visited:
                continue
            if perm[1] != index and perm[1] != _mirror(index):
                raise AssertionError("external-vertex slide went wrong")
            target = perm[index]
            next_vertex = perm[1]
            prev_vertex = perm.index(1)
            perm[1] = target
            perm[prev_vertex] = next_vertex
            perm[index] = 1
            delta = np.copy(mom[:, prev_vertex] - mom[:, 1])
            mom[:, 1] = mom[:, index]
            mom[:, index] += delta
            check_conservation(perm, mom, interaction_pairs)
            out[tuple(perm)] = (mom, sym_factor)
            visited.append(index)
            if target not in visited:
                to_visit.extend([target, _mirror(target)])
                start_perm.extend([tuple(perm), tuple(perm)])
                start_mom.extend([mom, mom])
    return out


def polar_canonical(perm: Perm, order: int) -> Perm:
    """Canonical form of a polar permutation under the internal-interaction
    deformation group: interaction relabeling x half swaps x direct/exchange.

    Minimum over (order-1)! relabelings x 2^(order-1) half-swap masks, with
    the direct/exchange choice normalized independently per interaction
    (it only swaps the two values at that interaction's slots).
    """
    import itertools as it

    g_num = len(perm)
    ints = list(range(1, order))
    n_int = len(ints)
    best = None
    m = [0] * g_num
    m[0], m[1] = 0, 1
    for sigma in it.permutations(ints):
        for mask in range(1 << n_int):
            for j, old in enumerate(sigma):
                h = (mask >> j) & 1
                m[2 * old] = 2 * (ints[j]) + h
                m[2 * old + 1] = 2 * (ints[j]) + (1 - h)
            q = [0] * g_num
            for s in range(g_num):
                q[m[s]] = m[perm[s]]
            for j in ints:  # D2E normalization per interaction
                a, b = 2 * j, 2 * j + 1
                if q[a] > q[b]:
                    q[a], q[b] = q[b], q[a]
            t = tuple(q)
            if best is None or t < best:
                best = t
    return best


def group_polar(polar_dict: Dict[Perm, Tuple[np.ndarray, float]],
                order: int, time_rotation: bool = True
                ) -> List[Tuple[Perm, np.ndarray, float]]:
    """Merge equivalent labeled polar diagrams (polar.py:131-176).

    The deformation group acts on internal interactions 1..order-1 only.
    Uses canonical forms (polynomial cost) instead of the reference's
    explicit deformation-list expansion (exponential at order 6).
    Returns [(representative, loop_basis, sym_factor * class_size)].
    """
    classes: Dict[Perm, List[Perm]] = {}
    order_seen: List[Perm] = []
    for perm in polar_dict:
        key = polar_canonical(perm, order)
        if key not in classes:
            classes[key] = []
            order_seen.append(key)
        classes[key].append(perm)
    out = []
    for key in order_seen:
        members = classes[key]
        rep = members[0]
        basis, sym = polar_dict[rep]
        out.append((rep, basis, sym * len(members)))
    return out
