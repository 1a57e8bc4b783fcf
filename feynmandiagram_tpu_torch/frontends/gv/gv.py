"""GV table loading entry points (reference GV.jl:52-114).

Table resolution order:
1. the path set via ``gv.set_table_path`` / ``FDTPU_GV_TABLES``
2. the package-bundled ``tables/`` directory (self-generated)

The bundled ``groups_vertex4`` tables are plain files.  The other five
directories ship packed in ``tables/groups.tar.xz`` (0.15 MB for 26 MB of
text) and are unpacked, byte for byte, into ``tables/`` at first use.
"""
from __future__ import annotations

import os
import shutil
import tarfile
import tempfile
from typing import List, Optional

from ..common import Alli, Filter, NoHartree, PHEr, PHr, PPr
from ...utils.profiling import count, phased
from .readfile import read_diagrams, read_diagrams_feynman, read_vertex4_diagrams

_BUNDLED = os.path.join(os.path.dirname(__file__), "tables")
_ARCHIVE = os.path.join(_BUNDLED, "groups.tar.xz")
PACKED_GROUPS = ("groups_charge", "groups_free_energy", "groups_green", "groups_sigma",
                 "groups_spin")

_GROUP_DIR = {
    "spinPolar": ("groups_spin", "Polar"),
    "chargePolar": ("groups_charge", "Polar"),
    "sigma": ("groups_sigma", "Sigma"),
    "green": ("groups_green", "Green"),
    "freeEnergy": ("groups_free_energy", "FreeEnergy"),
}


def unpack_bundled_tables() -> str:
    """Unpack each directory of ``PACKED_GROUPS`` that ``tables/`` lacks
    from the bundled archive, and return the ``tables/`` directory.  Each
    directory is unpacked beside its place and renamed into it, so a
    process never reads a half-written directory; where processes race,
    the first rename wins."""
    missing = [d for d in PACKED_GROUPS if not os.path.isdir(os.path.join(_BUNDLED, d))]
    if not missing:
        return _BUNDLED
    tmp = tempfile.mkdtemp(prefix=".unpack-", dir=_BUNDLED)
    try:
        with tarfile.open(_ARCHIVE) as tar:
            tar.extractall(tmp, members=[m for m in tar.getmembers()
                                         if m.name.split("/")[0] in missing], filter="data")
        for d in missing:
            try:
                os.rename(os.path.join(tmp, d), os.path.join(_BUNDLED, d))
            except OSError:
                if not os.path.isdir(os.path.join(_BUNDLED, d)):
                    raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _BUNDLED


def _table_file(diag_type: str, order: int, v_order: int, g_order: int,
                vertex4_irreducible: bool = False) -> str:
    from . import _TABLE_PATH
    candidates = []
    if _TABLE_PATH:
        candidates.append(_TABLE_PATH)
    candidates.append(_BUNDLED)
    if diag_type in ("vertex4", "vertex4I"):
        sub, prefix = "groups_vertex4", ("Vertex4I" if vertex4_irreducible else "Vertex4")
    else:
        sub, prefix = _GROUP_DIR[diag_type]
        unpack_bundled_tables()
    fname = f"{prefix}{order}_{v_order}_{g_order}.diag"
    for base in candidates:
        path = os.path.join(base, sub, fname)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"GV table {sub}/{fname} not found under {candidates}; set "
        "FDTPU_GV_TABLES or generate tables with "
        "python -m feynmandiagram_tpu_torch.frontends.gv.generator")


@phased("diagsGV")
def diagsGV(diag_type: str, order: int, g_order: Optional[int] = None,
            v_order: Optional[int] = None, *, label_prod=None,
            spin_polar_para: float = 0.0, tau_labels=None,
            filter=(NoHartree,)):
    """Load given-type diagrams of a given order (GV.jl:52-93).

    With ``g_order``/``v_order`` given, returns the FeynmanGraph path tuple
    ``(graphs, label_prod, ext_t_labels)`` for the counterterm file
    ``Name{order}_{v_order}_{g_order}.diag``; otherwise returns the plain
    Graph list for ``Name{order}_0_0.diag``.
    """
    if diag_type not in _GROUP_DIR:
        raise ValueError(f"no support for {diag_type} diagram")
    if g_order is None and v_order is None:
        filename = _table_file(diag_type, order, 0, 0)
        return read_diagrams(filename, diag_type, filter=filter,
                             spin_polar_para=spin_polar_para)
    filename = _table_file(diag_type, order, v_order or 0, g_order or 0)
    return read_diagrams_feynman(filename, label_prod=label_prod,
                                 spin_polar_para=spin_polar_para,
                                 tau_labels=tau_labels, diag_type=diag_type)


@phased("diagsGV_series")
def diagsGV_series(diag_type: str, max_order: int, *, filter=(NoHartree,),
                   spin_polar_para: float = 0.0):
    """The renormalized series of ``diag_type`` to total order
    ``max_order``, every partition in one list of roots.

    A partition ``(o, v, g)`` is the diagrams of order ``o >= 1`` with ``v``
    interaction and ``g`` propagator counterterms, ``o + v + g <=
    max_order``.  For each ``o`` the diagrams ``Name{o}_0_0`` are read on
    the Graph path (``diagsGV``) and optimized, and Taylor-mode AD
    (``taylorAD``, in the bare propagators and interactions, to
    ``max_order - o`` each) makes their counterterms, as FeynmanDiagram.jl
    renormalizes a series (``src/utility.jl``); the coefficients with ``g +
    v <= max_order - o`` are kept.  At ``o = max_order`` there is nothing to
    expand, and the diagrams are their partition ``(o, 0, 0)`` as read:
    ``taylorAD`` adds the series of a sum's terms one after another, so its
    order-0 coefficient of a sum of n diagrams is a chain n nodes deep (at
    order 6 that chain lowers to 2,308 levels, against 299 without it).  The
    roots are put in the order of their partitions, sorted by ``(o, v, g)``,
    each partition's in the order the file gives, and optimized once more
    together.

    Returns ``(roots, keys, n_loop, n_tau)``: each root's partition
    ``(o, v, g)``, and the loops and times the series spans.  Runs as the
    set-up phase ``diagsGV_series`` and adds the partitions it built to the
    counter ``diagsGV_series.partitions`` (``utils.profiling``).
    """
    from ...computational_graph import optimize_inplace
    from ...utility import taylorAD
    from ..diagram_id import BareGreenId, BareInteractionId

    parts = {}
    n_loop = n_tau = 0
    for o in range(1, max_order + 1):
        graphs = diagsGV(diag_type, o, filter=filter, spin_polar_para=spin_polar_para)
        optimize_inplace(graphs, level=1)
        for g in graphs:
            for leaf in g.leaves():
                n_loop = max(n_loop, len(leaf.properties.extK))
                n_tau = max(n_tau, max(leaf.properties.extT))
        m = max_order - o
        if m == 0:
            parts[o, 0, 0] = graphs
            continue
        by_order = taylorAD(graphs, [m, m], [lambda p: isinstance(p, BareGreenId),
                                             lambda p: isinstance(p, BareInteractionId)])
        for (g_order, v_order), coeffs in by_order.items():
            if g_order + v_order <= m:
                parts[o, v_order, g_order] = coeffs
    keys = [key for key in sorted(parts) for _ in parts[key]]
    roots = [g for key in sorted(parts) for g in parts[key]]
    optimize_inplace(roots, level=1)
    count("diagsGV_series.partitions", len(parts))
    return roots, keys, n_loop, n_tau


@phased("diagsGV_ver4")
def diagsGV_ver4(order: int, *, spin_polar_para: float = 0.0,
                 channels=(PHr, PHEr, PPr, Alli), filter=(NoHartree,)):
    """Load 4-point vertex diagrams of a given order (GV.jl:106-114)."""
    irreducible = list(channels) == [Alli]
    filename = _table_file("vertex4", order, 0, 0, vertex4_irreducible=irreducible)
    return read_vertex4_diagrams(filename, spin_polar_para=spin_polar_para,
                                 channels=channels, filter=filter)
