"""The renormalized self-energy from the GV tables by the port's front end:
``frontends.gv.diagsGV_series`` to the configuration's ``max_order``, every
partition ``(o, v, g)`` with ``o + v + g <= max_order`` in one list."""
from __future__ import annotations


def roots(cfg: dict):
    from feynmandiagram_tpu_torch import frontends
    from feynmandiagram_tpu_torch.frontends.gv import diagsGV_series

    out, _, n_loop, n_tau = diagsGV_series(
        cfg["diag_type"], cfg["max_order"],
        filter=tuple(getattr(frontends, f) for f in cfg["filter"]),
        spin_polar_para=cfg["spin_polar_para"])
    return out, n_loop, n_tau
