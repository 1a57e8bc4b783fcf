"""Parser for GV ``.diag`` Hugenholtz-diagram table files.

Reference: FeynmanDiagram.jl/src/frontend/GV_diagrams/readfile.jl.  Format
documented in SURVEY.md Appendix A: a header (DiagNum/GNum/Ver4Num/LoopNum/
TauNum/ExtTauIndex ...) followed by per-diagram blocks (Permutation,
SymFactor, GType, VertexBasis, LoopBasis, Ver4Legs, WType, SpinFactor, and
for vertex4 files Channel / Di-Ex / Proper flags).

Vertex/propagator indices inside this module are kept 1-based exactly as in
the files (offset = -1 shifts the 0-based file entries up by one), so the
bookkeeping matches the reference line by line.
"""
from __future__ import annotations

import io as _io
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...computational_graph import Graph, PROD, SUM, multi_product, linear_combination
from ...computational_graph.feynman_graph import (FeynmanGraph, feynman_diagram,
                                                  interaction as fg_interaction,
                                                  feynman_linear_combination)
from ...quantum_operators import (OperatorProduct, fermionic_annihilation,
                                  fermionic_creation, normal_order, real_classic)
from ..common import (Alli, AnalyticProperty, ChargeCharge, Dynamic, Instant,
                      NoHartree, PHEr, PHr, PPr, Proper, Response, SpinSpin,
                      TwoBodyChannel, UpDown, UpUp)
from ..diagram_id import (BareGreenId, BareInteractionId, GenericId, PolarId,
                          SigmaId, Ver4Id)
from ..label_product import LabelProduct

_INT_RE = re.compile(r"[-+]?\d+")

_KEYWORDS = ["Type", "DiagNum", "Order", "GNum", "Ver4Num", "LoopNum",
             "ExtLoopIndex", "DummyLoopIndex", "TauNum", "ExtTauIndex",
             "DummyTauIndex"]
_KEYWORDS_VER4 = ["Type", "DiagNum", "Order", "GNum", "Ver4Num", "LoopNum",
                  "ExtLoopIndex", "DummyLoopIndex", "TauNum", "DummyTauIndex"]


def _ints(line: str) -> List[int]:
    return [int(m.group()) for m in _INT_RE.finditer(line)]


def _read_blocks(f) -> List[List[str]]:
    """Split the remaining file into per-diagram line blocks."""
    blocks: List[List[str]] = []
    current: List[str] = []
    for line in f:
        if line.strip() == "":
            if current:
                blocks.append(current)
                current = []
        else:
            current.append(line.rstrip("\n"))
    if current:
        blocks.append(current)
    return blocks


def _exchange(perm: List[int], ver4_legs: List[List[int]], index: int,
              ext_num: int = 2, *, offset_ver4: int = 0
              ) -> Tuple[List[int], List[List[int]]]:
    """Select a direct/exchange assignment per interaction line by the bits of
    ``index - 1`` (MSB = line 1) and swap the outgoing legs accordingly.
    All entries are 1-based.  Reference: readfile.jl:15-28.
    """
    n = len(ver4_legs) - offset_ver4
    permu_ex = list(perm)
    legs_ex = [list(l) for l in ver4_legs]
    for i in range(1, n + 1):  # line i controlled by bit (n - i)
        if (index - 1) >> (n - i) & 1:
            loc1 = perm.index(2 * i - 1 + ext_num)
            loc2 = perm.index(2 * i + ext_num)
            permu_ex[loc1], permu_ex[loc2] = permu_ex[loc2], permu_ex[loc1]
            legs_ex[i - 1 + offset_ver4][1], legs_ex[i - 1 + offset_ver4][3] = \
                ver4_legs[i - 1 + offset_ver4][3], ver4_legs[i - 1 + offset_ver4][1]
    return permu_ex, legs_ex


def _spin_factor_value(spin_factor: int, spin_polar_para: float) -> float:
    """sign(s) * (2/(1+p))^log2|s| (readfile.jl:374,546)."""
    return math.copysign(1, spin_factor) * \
        (2.0 / (1.0 + spin_polar_para)) ** math.log2(abs(spin_factor))


class _Block:
    """One per-diagram block parsed into fields (1-based where applicable)."""

    def __init__(self, lines: List[str], g_num: int, ver_num: int, loop_num: int,
                 *, has_channel: bool = False, offset: int = -1):
        it = iter(lines)

        def expect(tag):
            line = next(it)
            if tag not in line:
                raise ValueError(f"expected '{tag}', got '{line}'")

        expect("Permutation")
        self.permutation = [x - offset for x in _ints(next(it))]
        if len(set(self.permutation)) != g_num:
            raise ValueError("invalid permutation")
        expect("SymFactor")
        self.symfactor = float(next(it))
        self.channel: Optional[TwoBodyChannel] = None
        if has_channel:
            expect("Channel")
            name = next(it).strip()
            self.channel = {"PHr": PHr, "PHEr": PHEr, "PPr": PPr, "Alli": Alli}[name]
        expect("GType")
        self.op_g_type = _ints(next(it))
        expect("VertexBasis")
        self.tau_labels_raw = _ints(next(it))
        next(it)  # second row of VertexBasis (incoming taus; unused)
        expect("LoopBasis")
        basis = np.zeros((g_num, loop_num), int)
        for i in range(loop_num):
            row = _ints(next(it))
            if len(row) != g_num:
                raise ValueError("bad LoopBasis row")
            basis[:, i] = row
        self.current_basis = basis
        expect("Ver4Legs")
        if ver_num == 0:
            self.ver4_legs: List[List[int]] = []
        else:
            strs = next(it).split("|")
            self.ver4_legs = [_ints(s) for s in strs[:ver_num]]
        expect("WType")
        self.op_w_type = _ints(next(it)) if ver_num > 0 else []
        expect("SpinFactor")
        self.spin_factors = _ints(next(it))
        self.di_ex: Optional[List[int]] = None
        self.proper: Optional[List[int]] = None
        for line in it:
            if "Di/Ex" in line:
                self.di_ex = _ints(next(it))
            elif "Proper/ImProper" in line:
                self.proper = _ints(next(it))


def _parse_header_lines(f, keywords):
    vals = {"DiagNum": 1, "GNum": 2, "Ver4Num": 0, "LoopNum": 1, "TauNum": 2,
            "ExtTauIndex": []}
    line_num = 0  # first header line is the "#Type:" tag (keywords[0])
    while True:
        line = f.readline()
        if not line.strip():
            break
        kw = keywords[line_num] if line_num < len(keywords) else None
        if kw == "DiagNum":
            vals["DiagNum"] = _ints(line)[0]
        elif kw == "GNum":
            vals["GNum"] = _ints(line)[0]
        elif kw == "Ver4Num":
            nums = _ints(line)
            vals["Ver4Num"] = nums[1] if len(nums) > 1 else nums[0]
        elif kw == "LoopNum":
            vals["LoopNum"] = _ints(line)[0]
        elif kw == "TauNum":
            vals["TauNum"] = _ints(line)[0]
        elif kw == "ExtTauIndex":
            vals["ExtTauIndex"] = _ints(line)
        line_num += 1
    return vals


# ---------------------------------------------------------------------------
# Graph path (readfile.jl:412-588) — the production route
# ---------------------------------------------------------------------------

def read_diagrams(filename: str, diag_type: str, *, filter=(NoHartree,),
                  spin_polar_para: float = 0.0) -> List[Graph]:
    """Read a .diag file into Graph roots grouped by external tau labels.

    ``diag_type``: 'sigma' | 'green' | 'chargePolar' | 'spinPolar' | 'freeEnergy'.
    """
    with open(filename) as f:
        hdr = _parse_header_lines(f, _KEYWORDS)
        blocks = _read_blocks(f)

    diag_num, g_num = hdr["DiagNum"], hdr["GNum"]
    ver_num, loop_num = hdr["Ver4Num"], hdr["LoopNum"]
    ext_index = hdr["ExtTauIndex"]
    offset_ver4 = 1 if diag_type == "sigma" else 0

    diagrams = [
        _read_one_diagram(_Block(blocks[i], g_num, ver_num, loop_num),
                          diag_type, g_num, ver_num, loop_num, list(ext_index),
                          spin_polar_para, filter=filter, offset_ver4=offset_ver4)
        for i in range(diag_num)
    ]

    if diag_type == "freeEnergy":
        return [linear_combination(diagrams, [1.0] * len(diagrams),
                                   properties=diagrams[0].properties)]
    ext_t_labels = [g.properties.extT for g in diagrams]
    groups: Dict[tuple, List[Graph]] = {}
    order: List[tuple] = []
    for g, key in zip(diagrams, ext_t_labels):
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(g)
    out = []
    for key in order:
        gid = groups[key][0].properties
        out.append(linear_combination(groups[key], [1.0] * len(groups[key]),
                                      properties=gid))
    return out


def _read_one_diagram(b: _Block, diag_type: str, g_num: int, ver_num: int,
                      loop_num: int, ext_index: List[int], spin_polar_para: float,
                      *, filter=(NoHartree,), offset: int = -1,
                      offset_ver4: int = 0) -> Graph:
    """(readfile.jl:475-588)."""
    is_dynamic = ver_num != 1
    permutation = b.permutation
    tau_labels = [x - offset for x in b.tau_labels_raw]

    ext_index = [x - offset for x in ext_index]
    if diag_type == "sigma":
        ext_index[1] = permutation.index(ext_index[0]) + 1
    ext_num = len(ext_index)
    extK = np.zeros(loop_num)

    greens = []
    for ind1_0, ind2 in enumerate(permutation):
        ind1 = ind1_0 + 1
        if b.op_g_type[ind1 - 1] == -2:
            continue
        diagid = BareGreenId(k=b.current_basis[ind1 - 1, :],
                             t=(tau_labels[ind1 - 1], tau_labels[ind2 - 1]))
        greens.append(Graph([], properties=diagid))
    fermi_green_prod = Graph(greens, operator=PROD)

    interactions = []
    spinfactors_existed = []
    for iex, spin_factor in enumerate(b.spin_factors, start=1):
        if spin_factor == 0:
            continue
        spinfactors_existed.append(_spin_factor_value(spin_factor, spin_polar_para))
        permu, ver4_legs_ex = _exchange(permutation, b.ver4_legs, iex, ext_num,
                                        offset_ver4=offset_ver4)
        leafs = []
        for ver_leg in ver4_legs_ex:
            ind1, ind2 = ver_leg[1] - offset, ver_leg[3] - offset
            current = b.current_basis[ver_leg[0] - offset - 1, :] \
                - b.current_basis[ind1 - 1, :]
            other = b.current_basis[ind2 - 1, :] - b.current_basis[ver_leg[2] - offset - 1, :]
            if not np.array_equal(current, other):
                raise AssertionError("momentum not conserved on interaction line")
            diagid = BareInteractionId(ChargeCharge, k=current,
                                      t=(tau_labels[ind1 - 1], tau_labels[ind2 - 1]))
            leafs.append(Graph([], properties=diagid))
        if not leafs:
            continue
        interactions.append(Graph(leafs, operator=PROD))

    inner_loop_num = loop_num - ext_num + 1
    if diag_type == "freeEnergy":
        inner_loop_num -= 1
        diagid = GenericId(inner_loop_num)
    elif diag_type == "chargePolar":
        diagid = PolarId(inner_loop_num, ChargeCharge, k=extK,
                         t=tuple(tau_labels[i - 1] for i in ext_index))
    elif diag_type == "spinPolar":
        diagid = PolarId(inner_loop_num, SpinSpin, k=extK,
                         t=tuple(tau_labels[i - 1] for i in ext_index))
    elif diag_type == "sigma":
        diagid = SigmaId(inner_loop_num, Dynamic if is_dynamic else Instant, k=extK,
                         t=tuple(tau_labels[i - 1] for i in ext_index))
    elif diag_type == "green":
        # NOTE: the reference Graph-path reader has no :green branch
        # (readfile.jl:568-578 leaves diagid undefined); a GreenId is the
        # natural extension here
        from ..diagram_id import GreenId
        diagid = GreenId(inner_loop_num, Dynamic if is_dynamic else Instant, k=extK,
                         t=tuple(tau_labels[i - 1] for i in ext_index))
    else:
        diagid = GenericId(inner_loop_num)

    factors = [s * b.symfactor for s in spinfactors_existed]
    if not interactions:
        return Graph([fermi_green_prod], subgraph_factors=factors[:1] or [b.symfactor],
                     operator=SUM, properties=diagid)
    inters = Graph(interactions, subgraph_factors=factors, operator=SUM)
    return multi_product(fermi_green_prod, inters, properties=diagid)


# ---------------------------------------------------------------------------
# vertex4 path (readfile.jl:191-410)
# ---------------------------------------------------------------------------

def read_vertex4_diagrams(filename: str, *, spin_polar_para: float = 0.0,
                          filter=(NoHartree,), channels=(PHr, PHEr, PPr, Alli)
                          ) -> List[Graph]:
    with open(filename) as f:
        hdr = _parse_header_lines(f, _KEYWORDS_VER4)
        blocks = _read_blocks(f)

    diag_num, g_num = hdr["DiagNum"], hdr["GNum"]
    ver_num, loop_num = hdr["Ver4Num"], hdr["LoopNum"]

    diagrams: List[Graph] = []
    for i in range(diag_num):
        b = _Block(blocks[i], g_num, ver_num, loop_num, has_channel=True)
        diags = _read_one_vertex4(b, g_num, ver_num, loop_num, spin_polar_para,
                                  channels=channels, filter=filter)
        diagrams.extend(diags)

    inner_loop_num = loop_num - 3
    para = (2, inner_loop_num)

    groups: Dict[tuple, List[Graph]] = {}
    keys_order: List[tuple] = []
    for g in diagrams:
        prop = g.properties
        key = (prop.extT, prop.channel, prop.para[0])
        if key not in groups:
            groups[key] = []
        groups[key].append(g)
        short = (prop.extT, prop.channel)
        if short not in keys_order:
            keys_order.append(short)

    graphvec: List[Graph] = []
    for extT, channel in keys_order:
        key_di = (extT, channel, 0)
        key_ex = (extT, channel, 1)
        gid_di = groups[key_di][0].properties
        gud = linear_combination(groups[key_di], [1.0] * len(groups[key_di]),
                                 properties=gid_di)  # Direct = UpDown
        g_ex = linear_combination(groups[key_ex], [1.0] * len(groups[key_ex]),
                                  properties=groups[key_ex][0].properties)
        guu_id = Ver4Id(para, UpUp, gid_di.type, k=gid_di.extK, t=gid_di.extT,
                        chan=gid_di.channel)
        guu = Graph([gud, g_ex], properties=guu_id)
        graphvec.extend([guu, gud])
    return graphvec


def _read_one_vertex4(b: _Block, g_num: int, ver_num: int, loop_num: int,
                      spin_polar_para: float, *, channels, filter,
                      offset: int = -1) -> List[Graph]:
    """(readfile.jl:267-410)."""
    flag_proper = Proper in filter
    is_dynamic = ver_num != 1
    if b.channel not in channels:
        return []
    permutation = b.permutation
    tau_labels = b.tau_labels_raw  # NOTE: vertex4 taus are NOT offset-shifted

    inner_loop_num = loop_num - 3
    extK = [np.zeros(loop_num) for _ in range(4)]
    for i in range(3):
        extK[i][i] = 1.0
        extK[3][i] = (-1.0) ** i
    ext_index = [1, 0, 2, 0]
    for ind1_0, ind2 in enumerate(permutation):
        ind1 = ind1_0 + 1
        if ind1 in (1, 2):
            continue
        if b.op_g_type[ind1 - 1] == -2:
            if ind2 == 1:
                ext_index[1] = ind1
            elif ind2 == 2:
                ext_index[3] = ind1
            else:
                raise ValueError(f"bad GType for ({ind1}, {ind2})")

    greens = []
    for ind1_0, ind2 in enumerate(permutation):
        ind1 = ind1_0 + 1
        if b.op_g_type[ind1 - 1] == -2:
            continue
        diagid = BareGreenId(k=b.current_basis[ind1 - 1, :],
                             t=(tau_labels[ind1 - 1], tau_labels[ind2 - 1]))
        greens.append(Graph([], properties=diagid))
    fermi_green_prod = Graph(greens, operator=PROD)

    interactions_di: List[Graph] = []
    interactions_ex: List[Graph] = []
    for iex, spin_factor in enumerate(b.spin_factors, start=1):
        if spin_factor == 0:
            continue
        if flag_proper and b.proper[iex - 1] == 1:
            continue
        # NOTE: as in the reference (readfile.jl:393-395), the vertex4 path
        # uses the raw integer spin factor, not the spin-polarized value
        permu, ver4_legs_ex = _exchange(permutation, b.ver4_legs, iex)
        leafs = []
        ext_index[0] = permu[0]
        ext_index[2] = permu[1]
        for ver_leg in ver4_legs_ex:
            ind1, ind2 = ver_leg[1] - offset, ver_leg[3] - offset
            current = b.current_basis[ver_leg[0] - offset - 1, :] \
                - b.current_basis[ind1 - 1, :]
            other = b.current_basis[ind2 - 1, :] - b.current_basis[ver_leg[2] - offset - 1, :]
            if not np.array_equal(current, other):
                raise AssertionError("momentum not conserved on interaction line")
            diagid = BareInteractionId(ChargeCharge, k=current,
                                      t=(tau_labels[ind1 - 1], tau_labels[ind2 - 1]))
            leafs.append(Graph([], properties=diagid))
        target = interactions_di if b.di_ex[iex - 1] == 0 else interactions_ex
        target.append(Graph(leafs, operator=PROD, factor=spin_factor * b.symfactor))

    ext_t = tuple(tau_labels[i - 1] for i in ext_index)
    diagid_di = Ver4Id((0, inner_loop_num), UpDown,
                       Dynamic if is_dynamic else Instant, k=extK, t=ext_t,
                       chan=b.channel)
    diagid_ex = Ver4Id((1, inner_loop_num), ChargeCharge,
                       Dynamic if is_dynamic else Instant, k=extK, t=ext_t,
                       chan=b.channel)
    if not fermi_green_prod.subgraphs:
        g_di = Graph(interactions_di, operator=SUM, properties=diagid_di)
        g_ex = Graph(interactions_ex, operator=SUM, properties=diagid_ex)
    else:
        g_di = multi_product(fermi_green_prod, Graph(interactions_di, operator=SUM),
                             properties=diagid_di)
        g_ex = multi_product(fermi_green_prod, Graph(interactions_ex, operator=SUM),
                             properties=diagid_ex)
    return [g_di, g_ex]


# ---------------------------------------------------------------------------
# FeynmanGraph path with LabelProduct labels (readfile.jl:112-189, 590-714)
# ---------------------------------------------------------------------------

def read_diagrams_feynman(filename: str, *, label_prod: Optional[LabelProduct] = None,
                          spin_polar_para: float = 0.0,
                          tau_labels: Optional[List[int]] = None,
                          diag_type: str = "polar"):
    """Read a .diag file into FeynmanGraphs with LabelProduct operator labels.

    Returns (graphs, label_prod, ext_t_labels).  For sigma files, graphs are
    grouped by external tau labels (static group first); otherwise a single
    combined graph is returned.
    """
    with open(filename) as f:
        hdr = _parse_header_lines(f, _KEYWORDS)
        blocks = _read_blocks(f)

    diag_num, g_num = hdr["DiagNum"], hdr["GNum"]
    ver_num, loop_num = hdr["Ver4Num"], hdr["LoopNum"]
    tau_num = hdr["TauNum"]
    ext_index = hdr["ExtTauIndex"]

    if tau_labels is None:
        tau_labels = list(range(1, tau_num + 1))
    if label_prod is None:
        loopbasis = [tuple([1.0] + [0.0] * (loop_num - 1))]
        label_prod = LabelProduct(tau_labels, loopbasis)
        max_loop_num = loop_num
    else:
        max_loop_num = len(label_prod.labels[1][-1])

    offset_ver4 = 1 if diag_type == "sigma" else 0
    diagrams = []
    ext_t_labels = []
    for i in range(diag_num):
        b = _Block(blocks[i], g_num, ver_num, loop_num)
        diag, label_prod, ext_t = _read_onediagram_feynman(
            b, g_num, ver_num, loop_num, list(ext_index), label_prod,
            spin_polar_para, diag_type=diag_type, max_loop_num=max_loop_num,
            offset_ver4=offset_ver4)
        diagrams.append(diag)
        ext_t_labels.append(tuple(ext_t))

    if diag_type == "sigma":
        if len(ext_index) != 2:
            raise AssertionError("sigma files must have 2 external tau indices")
        groups: Dict[tuple, List[FeynmanGraph]] = {}
        uniq: List[tuple] = []
        for g, key in zip(diagrams, ext_t_labels):
            if key not in groups:
                groups[key] = []
                uniq.append(key)
            groups[key].append(g)
        static_idx = next(i for i, key in enumerate(uniq)
                          if all(x == key[0] for x in key))
        if static_idx > 0:
            uniq[static_idx], uniq[0] = uniq[0], uniq[static_idx]
        graphvec = [feynman_linear_combination(groups[key], [1.0] * len(groups[key]))
                    for key in uniq]
        return graphvec, label_prod, uniq
    uniq = list(dict.fromkeys(ext_t_labels))
    if len(uniq) != 1:
        raise AssertionError("expected a single external tau group")
    return ([feynman_linear_combination(diagrams, [1.0] * diag_num)],
            label_prod, uniq)


def _read_onediagram_feynman(b: _Block, g_num: int, ver_num: int, loop_num: int,
                             ext_index: List[int], label_prod: LabelProduct,
                             spin_polar_para: float, *, diag_type: str,
                             max_loop_num: int, offset: int = -1,
                             offset_ver4: int = 0, static_bose: bool = True):
    """(readfile.jl:590-714)."""
    ext_index = [x - offset for x in ext_index]
    ext_num = len(ext_index)
    permutation = b.permutation
    tau_labels = [x - offset for x in b.tau_labels_raw]
    current_basis = np.zeros((g_num, max_loop_num), int)
    current_basis[:, :loop_num] = b.current_basis

    graphs: List[FeynmanGraph] = []
    spinfactors_existed: List[float] = []
    if diag_type == "sigma":
        ext_index[1] = permutation.index(ext_index[0]) + 1

    for iex, spin_factor in enumerate(b.spin_factors, start=1):
        if spin_factor == 0:
            continue
        spinfactors_existed.append(_spin_factor_value(spin_factor, spin_polar_para))
        permu, ver4_legs_ex = _exchange(permutation, b.ver4_legs, iex, ext_num,
                                        offset_ver4=offset_ver4)

        vertices: List[Optional[OperatorProduct]] = [None] * g_num
        connected_operators: List[Tuple[OperatorProduct, List[int]]] = []

        def extend_vertex(ind_1b: int, op: OperatorProduct) -> None:
            i = ind_1b - 1
            vertices[i] = op if vertices[i] is None else vertices[i] * op

        # fermionic operators (one creation/annihilation pair per propagator)
        for ind1_0, ind2 in enumerate(permu):
            ind1 = ind1_0 + 1
            current_index = label_prod.push_labelat(
                tuple(float(x) for x in current_basis[ind1 - 1, :]), 1)
            label1 = label_prod.index_to_linear(tau_labels[ind1 - 1] - 1, current_index)
            label2 = label_prod.index_to_linear(tau_labels[ind2 - 1] - 1, current_index)
            extend_vertex(ind1, fermionic_creation(label1))
            extend_vertex(ind2, fermionic_annihilation(label2))
            if b.op_g_type[ind1 - 1] < 0:
                continue
            connected_operators.append(
                (fermionic_annihilation(label2) * fermionic_creation(label1),
                 [b.op_g_type[ind1 - 1], 0]))

        # normal order each vertex OperatorProduct
        for ind in range(g_num):
            _, perm = normal_order(vertices[ind])
            vertices[ind] = OperatorProduct([vertices[ind][p] for p in perm])

        # bosonic operators per interaction line
        for iver, ver_leg in enumerate(b.ver4_legs, start=1):
            current = current_basis[ver_leg[0] - offset - 1, :] \
                - current_basis[ver_leg[1] - offset - 1, :]
            other = current_basis[ver_leg[3] - offset - 1, :] \
                - current_basis[ver_leg[2] - offset - 1, :]
            if not np.array_equal(current, other):
                raise AssertionError("momentum not conserved on interaction line")
            current_index = label_prod.push_labelat(
                tuple(float(x) for x in current), 1)
            ind1 = 2 * (iver - offset_ver4) - 1 + ext_num
            ind2 = 2 * (iver - offset_ver4) + ext_num
            label1 = label_prod.index_to_linear(tau_labels[ind1 - 1] - 1, current_index)
            label2 = label_prod.index_to_linear(tau_labels[ind2 - 1] - 1, current_index)
            extend_vertex(ind1, real_classic(label1))
            extend_vertex(ind2, real_classic(label2))
            connected_operators.append(
                (real_classic(label1) * real_classic(label2),
                 [0, b.op_w_type[2 * iver - 1]]))

        # external phi operators on external vertices
        if ext_num > 0 and diag_type != "sigma":
            external_current = tuple([1.0] + [0.0] * (max_loop_num - 1))
            label_prod.push_labelat(external_current, 1)
            for ind in ext_index:
                # NOTE: the reference (readfile.jl:697) passes an extra index
                # that its 2-axis index_to_linear ignores, so external labels
                # use basis slot 1; reproduced here with index 0.
                label = label_prod.index_to_linear(tau_labels[ind - 1] - 1, 0)
                extend_vertex(ind, real_classic(label))

        operators = OperatorProduct(vertices)
        ops_list = list(operators)
        contraction: List[List[int]] = []
        contraction_orders: List[List[int]] = []
        for connection, orders in connected_operators:
            first = ops_list.index(connection[0])
            last = len(ops_list) - 1 - ops_list[::-1].index(connection[1])
            contraction.append([first, last])
            contraction_orders.append(orders)

        graphs.append(feynman_diagram([fg_interaction(v) for v in vertices],
                                      contraction,
                                      contraction_orders=contraction_orders,
                                      factor=b.symfactor, is_signed=True))

    ext_t = [tau_labels[i - 1] for i in ext_index]
    return (feynman_linear_combination(graphs, spinfactors_existed),
            label_prod, ext_t)
