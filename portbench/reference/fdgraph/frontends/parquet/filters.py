"""Diagram validity filters (reference parquet/filter.jl)."""
from __future__ import annotations

import numpy as np

from . import DiagPara, GreenDiag
from ..common import Filter, Girreducible, NoFock, NoHartree, NoBubble, Proper, Wirreducible, vec_allclose


def not_proper(para: DiagPara, K) -> bool:
    """True if Proper filtering forbids this transfer momentum (filter.jl:19-28)."""
    if Proper in para.filter:
        transfer = para.transferLoop
        if not transfer:
            raise ValueError("Initialize para.transferLoop to check proper diagrams.")
        K = np.asarray(K)
        t = np.asarray(transfer[:len(K)])
        if vec_allclose(t, K, rtol=1.49e-8):
            return True
    return False


def is_valid_g(filters, inner_loop_num: int = None) -> bool:
    """Can a Green's function with this loop count exist? (filter.jl:31-47)."""
    if inner_loop_num is None:  # called with a DiagPara
        para = filters
        if para.type != GreenDiag:
            raise ValueError("is_valid_g(para) expects a GreenDiag para")
        return is_valid_g(para.filter, para.innerLoopNum)
    if (NoFock in filters) and (NoHartree in filters) and inner_loop_num == 1:
        return False
    if (Girreducible in filters) and inner_loop_num > 0:
        return False
    return True


def is_valid_sigma(filters, inner_loop_num: int, subdiagram: bool) -> bool:
    """Can a self-energy with this loop count exist? (filter.jl:49-64)."""
    if inner_loop_num < 0:
        raise ValueError("inner_loop_num must be >= 0")
    if inner_loop_num == 0:
        return False
    if subdiagram and (Girreducible in filters):
        return False
    if subdiagram and (NoFock in filters) and (NoHartree in filters) and inner_loop_num == 1:
        return False
    return True


def is_valid_polarization(filters, inner_loop_num: int, subdiagram: bool) -> bool:
    """(filter.jl:66-78)."""
    if inner_loop_num < 0:
        raise ValueError("inner_loop_num must be >= 0")
    if inner_loop_num == 0:
        return False
    if subdiagram and (Wirreducible in filters):
        return False
    if subdiagram and (NoBubble in filters) and inner_loop_num == 1:
        return False
    return True
