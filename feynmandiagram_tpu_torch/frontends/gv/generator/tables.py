"""Serialize generated diagrams to the ``.diag`` table contract.

Ports of the reference ToString pipelines: polar.py:178-365 (polarization /
spin-polarization / Green2), selfenergy.py:42-241 (self-energy), and
free_energy.py:231-359.  Counterterm files distribute the requested
interaction (VerOrder) and self-energy (GOrder) counterterm orders over the
interaction lines / propagators.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .attach import attach_external_vertices, group_polar, vacuum_loop_basis
from .hugenholtz import find_loops, lnz_classes, swap_two_vertex

Perm = Tuple[int, ...]


def _distributions(total: int, slots: int) -> List[List[int]]:
    """All ways to distribute ``total`` among ``slots`` (polar.py:521-550)."""
    if slots == 0:
        return [[]] if total == 0 else []
    out = []

    def rec(prefix, remaining, k):
        if k == 0:
            if remaining == 0:
                out.append(prefix)
            return
        for i in range(remaining + 1):
            rec(prefix + [i], remaining - i, k - 1)

    rec([], total, slots)
    return out


def hugen_to_feyn(perm: Perm, order: int, first_vertex: int = 1) -> List[Perm]:
    """Expand a Hugenholtz permutation into its 2^k Feynman permutations by
    choosing direct/exchange per interaction (polar.py:367-385).

    Interaction j's choice swaps the SOURCES of the lines landing on its two
    halves; the bit order matches the reference (line ``first_vertex`` is the
    most significant choice as the list doubles).
    """
    feyn_list = [perm]
    for j in range(first_vertex, order):
        end1, end2 = 2 * j, 2 * j + 1
        start1 = perm.index(end1)
        start2 = perm.index(end2)
        new_list = []
        for p in feyn_list:
            lp = list(p)
            new_list.append(tuple(lp))
            lp[start1], lp[start2] = lp[start2], lp[start1]
            new_list.append(tuple(lp))
        feyn_list = new_list
    return feyn_list


def _fmt_row(vals) -> str:
    return "".join(f"{int(v):2d} " for v in vals)


class _DiagBlock:
    """Accumulates one per-diagram text block."""

    def __init__(self):
        self.lines: List[str] = []

    def add(self, tag: str, *rows):
        self.lines.append(f"# {tag}")
        self.lines.extend(r for r in rows if r != "")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _header(diag_type: str, diag_num: int, order: int, g_num: int,
            ver4_num: int, loop_num: int, tau_num: int,
            ext_loop_index: Optional[int], ext_tau_index: Optional[Tuple[int, int]]
            ) -> str:
    t = [f"#Type: {diag_type}", f"#DiagNum: {diag_num}", f"#Order: {order}",
         f"#GNum: {g_num}", f"#Ver4Num: {ver4_num}",
         f"#LoopNum: {loop_num}",
         f"#ExtLoopIndex: {'' if ext_loop_index is None else ext_loop_index}",
         "#DummyLoopIndex: ",
         f"#TauNum: {tau_num}",
         ]
    if ext_tau_index is not None:
        t.append(f"#ExtTauIndex: {ext_tau_index[0]} {ext_tau_index[1]}")
    else:
        t.append("#ExtTauIndex: ")
    t.append("#DummyTauIndex: ")
    return "\n".join(t) + "\n\n"


def _polar_is_reducible(perm: Perm, basis: np.ndarray, order: int,
                        loop_num: int, *, is_selfenergy: bool, is_green: bool,
                        is_sympolar: bool, gtype: Sequence[int]) -> bool:
    """(polar.py:414-472)."""
    perm = list(perm)
    ext = np.zeros(loop_num, dtype=int)
    ext[0] = 1
    for i in range(1, order):
        start1 = perm.index(2 * i)
        ver_basis = basis[:, start1] - basis[:, 2 * i]
        if np.array_equal(ver_basis, ext) or np.array_equal(-ver_basis, ext):
            return True  # polarization insertion along the transfer momentum
        if np.all(ver_basis == 0):
            return True  # Hartree insertion
    if is_selfenergy:
        if perm[0] != 1 or gtype[0] != 0 or gtype[1] != 0:
            return True
        k = basis[:, 1]
        for i in range(2, len(perm)):
            if perm[i] != 0 and np.allclose(k, basis[:, i]):
                return True
            if perm[i] == 0 and gtype[i] != 0:
                return True
    if is_green:
        if perm[0] != 1 or gtype[0] != 0:
            return True
    if is_sympolar and perm[1] == 0:
        return True
    return False


def generate_polar(order: int, ver_order: int = 0, g_order: int = 0, *,
                   spin: int = 2, is_spin_polar: bool = False,
                   is_sym_polar: bool = True, is_green: bool = False,
                   lnz=None) -> Optional[str]:
    """Generate a Polar{order}_{ver}_{g}.diag table (or Green2 table).

    Mirrors main.py Generate + polar.ToString.
    """
    g_num = 2 * order
    ver4_num = order - 1
    loop_num = order + 1
    diags = _unique_polar_diagrams(order, lnz)
    if order == 1:
        # the single bubble is mirror-self-symmetric: keep it once, undoubled
        # (as in the shipped order-1 tables)
        is_sym_polar = False

    inter_cts = _distributions(ver_order, ver4_num)
    sigma_cts = _distributions(g_order, g_num)

    body = ""
    diag_num = 0
    for vertype in inter_cts:
        for gtype in sigma_cts:
            for perm, basis, sym in diags:
                feyn_list = hugen_to_feyn(perm, order)
                factor_list = [0 if _polar_is_reducible(
                    fp, basis, order, loop_num, is_selfenergy=False,
                    is_green=is_green, is_sympolar=is_sym_polar, gtype=gtype)
                    else 1 for fp in feyn_list]
                if all(f == 0 for f in factor_list):
                    continue
                sym_out = sym
                if is_sym_polar and not is_green and perm[0] == 1:
                    sym_out = sym * 2  # save one of each mirror pair
                block = _polar_block(perm, basis, sym_out, order, g_num,
                                     ver4_num, loop_num, vertype, gtype,
                                     feyn_list, factor_list, spin,
                                     is_spin_polar=is_spin_polar,
                                     is_green=is_green)
                if block is None:
                    continue
                body += block + "\n"
                diag_num += 1
    if not body:
        return None
    dtype = "Green2" if is_green else "Polarization"
    tau_num = ver4_num + 2
    return _header(dtype, diag_num, order, g_num, ver4_num, loop_num, tau_num,
                   0, (0, 1)) + body


def _polar_block(perm, basis, sym, order, g_num, ver4_num, loop_num, vertype,
                 gtype, feyn_list, factor_list, spin, *, is_spin_polar,
                 is_green) -> Optional[str]:
    b = _DiagBlock()
    b.add("Permutation", _fmt_row(perm))
    b.add("SymFactor", f"{sym}")
    grow = []
    for i in range(g_num):
        if is_green and i == 0:
            grow.append(-2)
        else:
            grow.append(gtype[i])
    b.add("GType", _fmt_row(grow))
    vb1 = [_polar_ver_basis(i) for i in range(g_num)]
    vb2 = [_polar_ver_basis(perm[i]) for i in range(g_num)]
    b.add("VertexBasis", _fmt_row(vb1), _fmt_row(vb2))
    rows = [_fmt_row(basis[i]) for i in range(loop_num)]
    b.add("LoopBasis", *rows)
    legs = ""
    for i in range(1, ver4_num + 1):
        end1, end2 = 2 * i, 2 * i + 1
        legs += f"{perm.index(end1):2d} {end1:2d} {perm.index(end2):2d} {end2:2d} |"
    b.add("Ver4Legs(InL,OutL,InR,OutR)", legs)
    wrow = ""
    for i in range(ver4_num):
        wrow += f"{vertype[i]:2d} {vertype[i]:2d} |"
    b.add("WType(Direct,Exchange)", wrow)
    spin_row = ""
    sign_base = (-1) ** (order - 1) / (1 if sym > 0 else -1)
    for idx, fp in enumerate(feyn_list):
        path = find_loops(fp)
        nloop = len(path)
        sign = (-1) ** nloop * sign_base
        if is_spin_polar and spin == 2:
            flag = any(0 in p and 1 in p for p in path)
            if not flag:
                spin_row += f"{0:2d} "
                continue
            spin_row += f"{int(spin ** nloop * sign * factor_list[idx]):2d} "
        else:
            sf = spin ** nloop * int(sign) * factor_list[idx]
            if is_green:
                sf //= 2
            spin_row += f"{int(sf):2d} "
    b.add("SpinFactor", spin_row)
    return b.text()


def _polar_ver_basis(index: int) -> int:
    """τ index of an operator for the polar layout (polar.py:387-391)."""
    return index if index <= 1 else index // 2 + 1


def generate_sigma(order: int, ver_order: int = 0, g_order: int = 0, *,
                   spin: int = 2, lnz=None) -> Optional[str]:
    """Generate a Sigma{order}_{ver}_{g}.diag table (selfenergy.py:42-241)."""
    g_num = 2 * order
    ver4_num = order  # the measuring pair (0,1) becomes a real interaction
    loop_num = order + 1
    diags = _unique_polar_diagrams(order, lnz)

    inter_cts = _distributions(ver_order, ver4_num)
    sigma_cts = _distributions(g_order, g_num)

    body = ""
    diag_num = 0
    for vertype in inter_cts:
        for gtype0 in sigma_cts:
            for perm0, basis0, sym in diags:
                feyn_list = hugen_to_feyn(perm0, order)
                factor_list = [0 if _sigma_is_hartree(fp, basis0, order)
                               else 1 for fp in feyn_list]
                if all(f == 0 for f in factor_list):
                    continue

                perm = list(perm0)
                gtype = list(gtype0)
                basis = np.copy(basis0)
                # move the source of the external line (…->0) to slot 2
                jp0 = perm.index(0)
                swap_ver = ()
                if jp0 > 2:
                    neighbor = jp0 + 1 if jp0 % 2 == 0 else jp0 - 1
                    perm = list(swap_two_vertex(tuple(perm), jp0, 2))
                    if neighbor != 2:
                        perm = list(swap_two_vertex(tuple(perm), neighbor, 3))
                    swap_ver = (jp0, neighbor)
                if swap_ver:
                    basis[:, [swap_ver[0], 2]] = basis[:, [2, swap_ver[0]]]
                    gtype[swap_ver[0]], gtype[2] = gtype[2], gtype[swap_ver[0]]
                    if swap_ver[1] != 2:
                        basis[:, [swap_ver[1], 3]] = basis[:, [3, swap_ver[1]]]
                        gtype[swap_ver[1]], gtype[3] = gtype[3], gtype[swap_ver[1]]
                col = 2 if jp0 >= 2 else 1
                locs = np.where((np.abs(basis[:, 0]) == 1)
                                & (basis[:, 0] == basis[:, col]))[0]
                loc_ext = locs[0]
                if _sigma_is_reducible(perm, basis, g_num, gtype):
                    continue
                for loc in locs[1:]:
                    if basis[loc, 0] == basis[loc_ext, 0]:
                        basis[loc, :] = basis[loc, :] - basis[loc_ext, :]
                    else:
                        basis[loc, :] = basis[loc, :] + basis[loc_ext, :]

                block = _sigma_block(tuple(perm), basis, sym, order, g_num,
                                     ver4_num, loop_num, vertype, gtype,
                                     loc_ext, spin)
                body += block + "\n"
                diag_num += 1
    if not body:
        return None
    ext_tau = (0, 1) if order == 1 else (0, 2)
    return _header("SelfEnergy", diag_num, order, g_num, ver4_num, loop_num,
                   ver4_num, 0, ext_tau) + body


def _sigma_is_hartree(perm: Perm, basis: np.ndarray, order: int) -> bool:
    """(selfenergy.py:266-302): zero-momentum interaction = Hartree."""
    perm = list(perm)
    for i in range(0, order):
        start1 = perm.index(2 * i)
        ver_basis = basis[:, start1] - basis[:, 2 * i]
        if np.all(ver_basis == 0):
            return True
    return False


def _sigma_is_reducible(perm, basis, g_num, gtype) -> bool:
    """(selfenergy.py:304-310): one-particle reducible or dressed ext line."""
    ext_k = basis[:, perm.index(0)]
    for i in range(g_num):
        if perm[i] != 0 and (np.allclose(ext_k, basis[:, i])
                             or np.allclose(-ext_k, basis[:, i])):
            return True
        if perm[i] == 0 and gtype[i] > 0:
            return True
    return False


def _sigma_block(perm, basis, sym, order, g_num, ver4_num, loop_num, vertype,
                 gtype, loc_ext, spin) -> str:
    b = _DiagBlock()
    b.add("Permutation", _fmt_row(perm))
    b.add("SymFactor", f"{sym}")
    grow = [(-2 if perm[i] == 0 else gtype[i]) for i in range(g_num)]
    b.add("GType", _fmt_row(grow))
    vb1 = [i // 2 for i in range(g_num)]
    vb2 = [perm[i] // 2 for i in range(g_num)]
    b.add("VertexBasis", _fmt_row(vb1), _fmt_row(vb2))
    basis_out = np.copy(basis)
    if loc_ext > 0:
        if basis[loc_ext, 0] == 1:
            basis_out[0, :] = basis[loc_ext, :]
        else:
            basis_out[0, :] = -basis[loc_ext, :]
        basis_out[loc_ext:-1, :] = basis[loc_ext + 1:, :]
        basis_out[-1, :] = basis[0, :]
    b.add("LoopBasis", *[_fmt_row(basis_out[i]) for i in range(loop_num)])
    legs = ""
    for i in range(0, ver4_num):
        end1, end2 = 2 * i, 2 * i + 1
        legs += f"{perm.index(end1):2d} {end1:2d} {perm.index(end2):2d} {end2:2d} |"
    b.add("Ver4Legs(InL,OutL,InR,OutR)", legs)
    wrow = ""
    for i in range(ver4_num):
        wrow += f"{vertype[i]:2d} {vertype[i]:2d} |"
    b.add("WType(Direct,Exchange)", wrow)
    spin_row = ""
    sign_base = (-1) ** (order - 1) / (1 if sym > 0 else -1)
    feyn_list = hugen_to_feyn(perm, order)
    for fp in feyn_list:
        prefactor = 0 if _sigma_is_hartree(fp, basis_out, order) else 1
        nloop = len(find_loops(fp)) - 1
        sign = (-1) ** nloop * sign_base
        spin_row += f"{int(spin ** nloop * sign * prefactor):2d} "
    b.add("SpinFactor", spin_row)
    return b.text()


def generate_free_energy(order: int, ver_order: int = 0, g_order: int = 0, *,
                         spin: int = 2, lnz=None) -> Optional[str]:
    """Generate FreeEnergy{order}_{ver}_{g}.diag (free_energy.py:231-359)."""
    if order == 0:
        # Zeroth order: the bare tr-ln-G0 loop with a g_order-th derivative
        # counterterm on the single measuring propagator.  GType -1 marks the
        # underived tr-ln measuring line (FreeEnergy0_0_0.diag convention).
        if ver_order > 0:
            return None
        b = _DiagBlock()
        b.add("Permutation", _fmt_row([0]))
        b.add("SymFactor", " 1.0")
        b.add("GType", _fmt_row([g_order if g_order > 0 else -1]))
        b.add("VertexBasis", _fmt_row([0]), _fmt_row([0]))
        b.add("LoopBasis", _fmt_row([1]))
        b.add("Ver4Legs(InL,OutL,InR,OutR)")
        b.add("WType(Direct,Exchange)")
        b.add("SpinFactor", f"{-spin:2d} ")
        return (_header("FreeEnergy", 1, 0, 1, 0, 1, 1, None, None)
                + b.text() + "\n")
    g_num = 2 * order
    ver4_num = order
    loop_num = order + 1
    if lnz is None:
        lnz = lnz_classes(order)
    inter_cts = _distributions(ver_order, ver4_num)
    sigma_cts = _distributions(g_order, g_num)

    body = ""
    diag_num = 0
    for vertype in inter_cts:
        for gtype in sigma_cts:
            for perm, sym in lnz:
                basis = vacuum_loop_basis(perm)
                feyn_list = hugen_to_feyn(perm, order, first_vertex=0)
                factor_list = []
                for fp in feyn_list:
                    has_tadpole = any(i == fp[i] for i in range(g_num))
                    factor_list.append(0 if has_tadpole else 1)
                block = _free_energy_block(perm, basis, sym, order, g_num,
                                           ver4_num, loop_num, vertype, gtype,
                                           feyn_list, factor_list, spin)
                body += block + "\n"
                diag_num += 1
    if not body:
        return None
    return _header("FreeEnergy", diag_num, order, g_num, ver4_num, loop_num,
                   ver4_num, None, None) + body


def _free_energy_block(perm, basis, sym, order, g_num, ver4_num, loop_num,
                       vertype, gtype, feyn_list, factor_list, spin) -> str:
    b = _DiagBlock()
    b.add("Permutation", _fmt_row(perm))
    b.add("SymFactor", f"{sym}")
    b.add("GType", _fmt_row(gtype))
    vb1 = [i // 2 for i in range(g_num)]
    vb2 = [perm[i] // 2 for i in range(g_num)]
    b.add("VertexBasis", _fmt_row(vb1), _fmt_row(vb2))
    b.add("LoopBasis", *[_fmt_row(basis[i]) for i in range(loop_num)])
    legs = ""
    for i in range(ver4_num):
        end1, end2 = 2 * i, 2 * i + 1
        legs += f"{perm.index(end1):2d} {end1:2d} {perm.index(end2):2d} {end2:2d} |"
    b.add("Ver4Legs(InL,OutL,InR,OutR)", legs)
    wrow = ""
    for i in range(ver4_num):
        wrow += f"{vertype[i]:2d} {vertype[i]:2d} |"
    b.add("WType(Direct,Exchange)", wrow)
    spin_row = ""
    sign_base = (-1) ** (order - 1) / (1 if sym > 0 else -1)
    for idx, fp in enumerate(feyn_list):
        nloop = len(find_loops(fp))
        sign = (-1) ** nloop * sign_base
        spin_row += f"{int(spin ** nloop * sign * factor_list[idx]):2d} "
    b.add("SpinFactor", spin_row)
    return b.text()


def generate_green(order: int, ver_order: int = 0, g_order: int = 0, *,
                   spin: int = 2, lnz=None) -> Optional[str]:
    """Green{order} tables run the polar pipeline one order higher (the
    extra order supplies the measuring line), with the header's Order kept
    at the Green-function order as in the shipped tables."""
    text = generate_polar(order + 1, ver_order, g_order, spin=spin,
                          is_spin_polar=False, is_sym_polar=False,
                          is_green=True, lnz=lnz)
    if text is None:
        return None
    return text.replace(f"#Order: {order + 1}\n", f"#Order: {order}\n", 1)


# ---------------------------------------------------------------------------
# pipeline glue
# ---------------------------------------------------------------------------

_polar_cache: Dict[int, List[Tuple[Perm, np.ndarray, float]]] = {}
_lnz_cache: Dict[int, list] = {}


def _get_lnz(order: int):
    if order not in _lnz_cache:
        _lnz_cache[order] = lnz_classes(order)
    return _lnz_cache[order]


def _unique_polar_diagrams(order: int, lnz=None):
    """lnZ(order-1) classes -> all unique polar topologies (main.py:8-56)."""
    if order == 1:
        # the single order-1 bubble: 0 -> 1 -> 0 (hand-canonical, as in the
        # reference order-1 tables)
        return [((1, 0), np.array([[1, 0], [1, 1]], dtype=int), -1.0)]
    if lnz is None and order in _polar_cache:
        return _polar_cache[order]
    lnz_list = lnz if lnz is not None else _get_lnz(order - 1)
    out = []
    for perm, sym in lnz_list:
        basis = vacuum_loop_basis(perm)
        polar_dict = attach_external_vertices(perm, basis, sym)
        out.extend(group_polar(polar_dict, order))
    if lnz is None:
        _polar_cache[order] = out
    return out


def write_table(path: str, text: Optional[str]) -> Optional[str]:
    if text is None:
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def generate_tables(out_dir: str, max_order: int = 4, *, spin: int = 2,
                    kinds=("sigma", "charge", "spin", "green", "free_energy"),
                    max_total_order: Optional[int] = None) -> List[str]:
    """Generate table files for all (order, ver_order, g_order) partitions
    with order + ver + g <= max_total_order (default: max_order)."""
    if max_total_order is None:
        max_total_order = max_order
    written = []

    def emit(kind, prefix, sub, gen, o, v, g):
        text = gen(o, v, g, spin=spin)
        p = write_table(os.path.join(out_dir, sub, f"{prefix}{o}_{v}_{g}.diag"), text)
        if p:
            written.append(p)

    for o in range(1, max_order + 1):
        for v in range(0, max_total_order):
            for g in range(0, max_total_order):
                if o + v + g > max_total_order:
                    continue
                if "sigma" in kinds and o >= 1:
                    emit("sigma", "Sigma", "groups_sigma", generate_sigma, o, v, g)
                if "charge" in kinds and o >= 1:
                    emit("charge", "Polar", "groups_charge",
                         lambda o_, v_, g_, spin: generate_polar(
                             o_, v_, g_, spin=spin, is_spin_polar=False), o, v, g)
                if "spin" in kinds and o >= 1:
                    emit("spin", "Polar", "groups_spin",
                         lambda o_, v_, g_, spin: generate_polar(
                             o_, v_, g_, spin=spin, is_spin_polar=True), o, v, g)
                if "green" in kinds and o >= 1:
                    emit("green", "Green", "groups_green", generate_green, o, v, g)
                if "free_energy" in kinds:
                    emit("free_energy", "FreeEnergy", "groups_free_energy",
                         generate_free_energy, o, v, g)
    return written


# ---------------------------------------------------------------------------
# vertex4 tables (reference vertex4.py + main_vertex4.py)
# ---------------------------------------------------------------------------

def _swap_two_vertex_pairs(perm, basis, i, j, k, l):
    """Swap slot pair (i, j) with (k, l) in the permutation and the
    corresponding loop-basis columns (diagram.py:76-94)."""
    p = list(perm)
    ip, kp = p.index(i), p.index(k)
    jp, lp = p.index(j), p.index(l)
    p[ip], p[kp] = k, i
    p[jp], p[lp] = l, j
    p[i], p[k] = p[k], p[i]
    p[j], p[l] = p[l], p[j]
    b = np.copy(basis)
    b[:, [i, k]] = b[:, [k, i]]
    b[:, [j, l]] = b[:, [l, j]]
    return tuple(p), b


def _ver4_normalize(perm, basis):
    """Move the interactions adjacent to the external slots 0/1 to the low
    vertex slots (vertex4.py:56-75)."""
    ext_v = [0, 0, 1, 1]
    num_ext = 0
    for i in range(4):
        if i % 2 == 0:
            i0 = perm[ext_v[i]]
        else:
            i0 = perm.index(ext_v[i])
        if i0 > 2 * i + 3 or i0 > 2 * num_ext + 3:
            num_ext += 1
            if i0 % 2 == 0:
                neighbor = i0 + 1
                perm, basis = _swap_two_vertex_pairs(perm, basis, i0, neighbor,
                                                     2 * num_ext, 2 * num_ext + 1)
            else:
                neighbor = i0 - 1
                perm, basis = _swap_two_vertex_pairs(perm, basis, neighbor, i0,
                                                     2 * num_ext, 2 * num_ext + 1)
        elif i0 // 2 > num_ext:
            num_ext += 1
    return perm, basis


def _ver4_is_reducible(perm, basis, g_num, ver4_num):
    """Hartree insertions + one-particle reducibility (vertex4.py:306-338)."""
    perm = list(perm)
    for i in range(1, ver4_num + 1):
        start1 = perm.index(2 * i)
        if np.all(basis[:, start1] - basis[:, 2 * i] == 0):
            return True
    ext4 = [list(basis[:, 0]), list(basis[:, 1])]
    ip = perm.index(0)
    if list(basis[:, ip]) == ext4[1]:
        return True
    ext4.append(list(basis[:, ip]))
    ip = perm.index(1)
    if list(basis[:, ip]) == ext4[0]:
        return True
    ext4.append(list(basis[:, ip]))
    for i in range(2, g_num):
        if perm[i] in (0, 1):
            continue
        if list(basis[:, i]) in ext4:
            return True
    return False


def _ver4_is_2p_reducible(perm, basis, g_num):
    """Two-particle reducibility along any channel (vertex4.py:340-365)."""
    perm = list(perm)
    ext4 = [list(basis[:, 0]), list(basis[:, 1])]
    ip = perm.index(0)
    if list(basis[:, ip]) == ext4[1]:
        return True
    ext4.append(list(basis[:, ip]))
    ip = perm.index(1)
    if list(basis[:, ip]) == ext4[0]:
        return True
    ext4.append(list(basis[:, ip]))
    q0 = np.array(ext4[0]) - np.array(ext4[2])
    q1 = np.array(ext4[1]) - np.array(ext4[2])
    q2 = np.array(ext4[0]) + np.array(ext4[1])
    for i in range(2, g_num):
        if perm[i] in (0, 1):
            continue
        if list(basis[:, i]) in ext4:
            return True
        for j in range(2, g_num):
            if perm[j] in (0, 1) or i == j:
                continue
            momm = basis[:, i] - basis[:, j]
            momp = basis[:, i] + basis[:, j]
            if (np.allclose(q0, momm) or np.allclose(q1, momm)
                    or np.allclose(q2, momp)):
                return True
    return False


def _ver4_is_proper(perm, basis, ver4_num):
    """No interaction carries the transfer momentum (vertex4.py:292-304)."""
    perm = list(perm)
    ext_loop = basis[:, 0] - basis[:, perm.index(0)]
    for i in range(1, ver4_num + 1):
        start1 = perm.index(2 * i)
        ver = basis[:, start1] - basis[:, 2 * i]
        if np.array_equal(ver, ext_loop) or np.array_equal(-ver, ext_loop):
            return False
    return True


def generate_vertex4(order: int, ver_order: int = 0, g_order: int = 0, *,
                     spin: int = 2, fully_irreducible: bool = False,
                     lnz=None) -> Optional[str]:
    """Generate Vertex4{order} / Vertex4I{order} tables (vertex4.py:41-267).

    Vertex-4 diagrams of order n are polarization-type topologies of order
    n+2; the two extra measuring lines become the external legs.
    """
    g_num = 2 * order + 4
    ver4_num = order + 1
    loop_num = order + 3
    polar_order = order + 2
    diags = _unique_polar_diagrams(polar_order, lnz)

    inter_cts = _distributions(ver_order, ver4_num)
    sigma_cts = _distributions(g_order, g_num)

    body = ""
    diag_num = 0
    for vertype in inter_cts:
        for gtype in sigma_cts:
            for perm0, basis0, sym in diags:
                perm, basis = _ver4_normalize(perm0, np.copy(basis0))
                feyn_list = hugen_to_feyn(perm, ver4_num + 1)
                factor_list = []
                for fp in feyn_list:
                    if (fp[0] == 1 or fp[1] == 0
                            or _ver4_is_reducible(fp, basis, g_num, ver4_num)
                            or (fully_irreducible
                                and _ver4_is_2p_reducible(fp, basis, g_num))):
                        factor_list.append(0)
                    else:
                        factor_list.append(1)
                if all(f == 0 for f in factor_list):
                    continue

                # Gaussian-eliminate the loop basis so the external columns
                # become e0, e1, e2 (and e0 - e1 + e2) (vertex4.py:91-115)
                perm_l = list(perm)
                ext_index = [0, perm_l.index(0), 1, perm_l.index(1)]
                extK = [np.zeros(loop_num) for _ in range(4)]
                for i in range(3):
                    extK[i][i] = 1.0
                    extK[3][i] = (-1.0) ** i
                cur = basis.astype(float)
                for i, iver in enumerate(ext_index[:3]):
                    locs = np.nonzero(cur[:, iver])[0]
                    if locs.size == 0:
                        raise AssertionError("wrong loop basis")
                    if cur[i, iver] == 0:
                        idx = locs[np.where(locs > i)[0][0]]
                        old = np.copy(cur)
                        cur[i, :] = old[idx, :] / old[idx, iver]
                        cur[idx, :] = old[i, :]
                        locs = locs[locs != idx]
                    elif cur[i, iver] != 1:
                        cur[i, :] /= cur[i, iver]
                    for j in locs:
                        if j == i:
                            continue
                        cur[j, :] -= cur[i, :] * cur[j, iver]
                for i, iver in enumerate(ext_index):
                    if not np.array_equal(extK[i], cur[:, iver]):
                        raise AssertionError("loop basis inconsistent with extK")
                basis = np.rint(cur).astype(int)

                block = _ver4_block(perm, basis, sym, order, g_num, ver4_num,
                                    loop_num, vertype, gtype, feyn_list,
                                    factor_list, spin)
                body += block + "\n"
                diag_num += 1
    if not body:
        return None
    header = _header("Vertex4", diag_num, order, g_num, ver4_num, loop_num,
                     ver4_num + 2, 0, None)
    # vertex4 headers carry no ExtTauIndex line (see groups_vertex4/*.diag)
    header = header.replace("#ExtTauIndex: \n", "")
    return header + body


def _ver4_block(perm, basis, sym, order, g_num, ver4_num, loop_num, vertype,
                gtype, feyn_list, factor_list, spin) -> str:
    perm_l = list(perm)
    # channel classification (vertex4.py:131-150; last match wins)
    ext4 = [basis[:, 0], basis[:, 1], basis[:, perm_l.index(0)],
            basis[:, perm_l.index(1)]]
    q0 = ext4[0] - ext4[2]
    q1 = ext4[1] - ext4[2]
    q2 = ext4[0] + ext4[1]
    chan = "Alli"
    for i in range(2, g_num):
        if perm_l[i] in (0, 1):
            continue
        for j in range(2, g_num):
            if perm_l[j] in (0, 1) or i == j:
                continue
            momm = basis[:, i] - basis[:, j]
            momp = basis[:, i] + basis[:, j]
            if np.allclose(q0, momm):
                chan = "PHr"
            elif np.allclose(q1, momm):
                chan = "PHEr"
            elif np.allclose(q2, momp):
                chan = "PPr"

    b = _DiagBlock()
    b.add("Permutation", _fmt_row(perm))
    b.add("SymFactor", f"{sym}")
    b.add("Channel: ", chan)
    grow = [(-2 if (perm_l[i] in (0, 1) or i in (0, 1)) else gtype[i])
            for i in range(g_num)]
    b.add("GType", _fmt_row(grow))
    vb1 = [i // 2 for i in range(g_num)]
    vb2 = [perm_l[i] // 2 for i in range(g_num)]
    b.add("VertexBasis", _fmt_row(vb1), _fmt_row(vb2))
    b.add("LoopBasis", *[_fmt_row(basis[i]) for i in range(loop_num)])
    legs = ""
    for i in range(1, ver4_num + 1):
        end1, end2 = 2 * i, 2 * i + 1
        legs += f"{perm_l.index(end1):2d} {end1:2d} {perm_l.index(end2):2d} {end2:2d} |"
    b.add("Ver4Legs(InL,OutL,InR,OutR)", legs)
    wrow = ""
    for i in range(ver4_num):
        wrow += f"{vertype[i]:2d} {vertype[i]:2d} |"
    b.add("WType(Direct,Exchange)", wrow)
    spin_row = ""
    is_direct = []
    is_proper = []
    sign_base = (-1) ** order / (1 if sym > 0 else -1)
    for idx, fp in enumerate(feyn_list):
        path = find_loops(fp)
        direct = any(0 in p and 1 in p for p in path)
        is_direct.append(1 if direct else 0)
        is_proper.append(0 if _ver4_is_proper(fp, basis, ver4_num) else 1)
        nloop = len(path) - 1
        sign = (-1) ** nloop * sign_base
        sf = spin ** nloop * int(sign) * factor_list[idx]
        if not direct:
            sf //= 2
        spin_row += f"{int(sf):2d} "
    b.add("SpinFactor", spin_row)
    b.add("Di/Ex", _fmt_row(is_direct))
    b.add("Proper/ImProper", _fmt_row(is_proper))
    return b.text()
