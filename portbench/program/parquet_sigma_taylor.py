"""The self-energy Sigma by the port's Parquet front end, expanded in its
counterterms: ``sigma`` at the configuration's ``innerLoopNum`` with the
external momentum on the first loop, ``optimize_inplace``, ``taylorAD`` to
``taylor_orders`` in the bare propagators and interactions, every order's
roots in one list sorted by order tuple, and ``optimize_inplace`` again."""
from __future__ import annotations

import numpy as np


def roots(cfg: dict):
    from feynmandiagram_tpu_torch import frontends
    from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
    from feynmandiagram_tpu_torch.frontends.diagram_id import BareGreenId, BareInteractionId
    from feynmandiagram_tpu_torch.frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
    from feynmandiagram_tpu_torch.utility import taylorAD

    para = DiagPara(type=SigmaDiag, innerLoopNum=cfg["innerLoopNum"], hasTau=True,
                    filter=tuple(getattr(frontends, f) for f in cfg["filter"]),
                    interaction=tuple(Interaction(getattr(frontends, r), getattr(frontends, t))
                                      for r, t in cfg["interaction"]))
    ext_k = np.zeros(para.totalLoopNum)
    ext_k[0] = 1.0
    out = [row["diagram"] for row in sigma(para, ext_k, False)]
    optimize_inplace(out, level=cfg["optimize_level"])
    by_order = taylorAD(out, cfg["taylor_orders"],
                        [lambda p: isinstance(p, BareGreenId),
                         lambda p: isinstance(p, BareInteractionId)])
    out = [g for o in sorted(by_order) for g in by_order[o]]
    optimize_inplace(out, level=cfg["optimize_level"])
    return out, para.totalLoopNum, para.totalTauNum
