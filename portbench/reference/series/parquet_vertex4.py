"""The four-point vertex Gamma4 by the frozen Parquet front end:
``vertex4`` at the configuration's ``innerLoopNum``, its filters and
interactions, then ``optimize_inplace`` at its level."""
from __future__ import annotations


def roots(cfg: dict):
    from ..fdgraph import frontends
    from ..fdgraph.computational_graph import optimize_inplace
    from ..fdgraph.frontends.parquet import DiagPara, Interaction, Ver4Diag, vertex4

    para = DiagPara(type=Ver4Diag, innerLoopNum=cfg["innerLoopNum"], hasTau=True,
                    filter=tuple(getattr(frontends, f) for f in cfg["filter"]),
                    interaction=tuple(Interaction(getattr(frontends, r), getattr(frontends, t))
                                      for r, t in cfg["interaction"]))
    out = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(out, level=cfg["optimize_level"])
    return (out, para.totalLoopNum, para.totalTauNum, frontends.BareGreenId,
            frontends.BareInteractionId)
