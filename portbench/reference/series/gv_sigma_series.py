"""The renormalized self-energy from the GV tables by the frozen front end:
for each order ``o`` of ``1 .. max_order`` the diagrams
``Sigma{o}_0_0.diag`` read on the Graph path (``readfile.read_diagrams``)
and optimized, their counterterms by ``taylorAD`` to ``max_order - o`` in
the bare propagators and interactions, the coefficients ``(g, v)`` with
``g + v <= max_order - o`` kept (at ``o = max_order``, with nothing to
expand, the diagrams as read), every partition ``(o, v, g)``'s roots in one
list sorted by partition, and ``optimize_inplace`` again.

The tables are the reference's own copy of the bundled archive
(``fdgraph/frontends/gv/tables/groups.tar.xz``); the files a build reads
are unpacked into a temporary directory outside the checkout, which goes
when the series is built."""
from __future__ import annotations

import os
import shutil
import tarfile
import tempfile

ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fdgraph",
                       "frontends", "gv", "tables", "groups.tar.xz")
PREFIX = {"sigma": ("groups_sigma", "Sigma")}


def _unpacked(diag_type: str, orders, into: str):
    """The paths of ``Name{o}_0_0.diag`` for each of ``orders``, unpacked
    from the archive into ``into``."""
    sub, name = PREFIX[diag_type]
    members = [f"{sub}/{name}{o}_0_0.diag" for o in orders]
    with tarfile.open(ARCHIVE) as tar:
        tar.extractall(into, members=[tar.getmember(m) for m in members], filter="data")
    return [os.path.join(into, m) for m in members]


def roots(cfg: dict):
    from ..fdgraph import frontends
    from ..fdgraph.computational_graph import optimize_inplace
    from ..fdgraph.frontends.diagram_id import BareGreenId, BareInteractionId
    from ..fdgraph.frontends.gv.readfile import read_diagrams
    from ..fdgraph.utility import taylorAD

    max_order = cfg["max_order"]
    filters = tuple(getattr(frontends, f) for f in cfg["filter"])
    tmp = tempfile.mkdtemp(prefix="portbench-gv-")
    try:
        paths = _unpacked(cfg["diag_type"], range(1, max_order + 1), tmp)
        parts = {}
        n_loop = n_tau = 0
        for o, path in enumerate(paths, start=1):
            graphs = read_diagrams(path, cfg["diag_type"], filter=filters,
                                   spin_polar_para=cfg["spin_polar_para"])
            optimize_inplace(graphs, level=cfg["optimize_level"])
            for g in graphs:
                for leaf in g.leaves():
                    n_loop = max(n_loop, len(leaf.properties.extK))
                    n_tau = max(n_tau, max(leaf.properties.extT))
            m = max_order - o
            if m == 0:
                parts[o, 0, 0] = graphs
                continue
            by_order = taylorAD(graphs, [m, m],
                                [lambda p: isinstance(p, BareGreenId),
                                 lambda p: isinstance(p, BareInteractionId)])
            for (g_order, v_order), coeffs in by_order.items():
                if g_order + v_order <= m:
                    parts[o, v_order, g_order] = coeffs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = [g for key in sorted(parts) for g in parts[key]]
    optimize_inplace(out, level=cfg["optimize_level"])
    return out, n_loop, n_tau, BareGreenId, BareInteractionId
