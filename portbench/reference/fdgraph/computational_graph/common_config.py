"""Global default dtypes for lowering/evaluation (reference common.jl:3-13).

The graph IR itself is dtype-agnostic on the host; these defaults feed the
lowering and the batched evaluators.
"""
import numpy as np


class _DType:
    def __init__(self):
        self.factor = np.float64
        self.weight = np.float64


_dtype = _DType()


def set_datatype(*, factor=np.float64, weight=np.float64):
    _dtype.factor = factor
    _dtype.weight = weight


def get_datatype():
    return _dtype
