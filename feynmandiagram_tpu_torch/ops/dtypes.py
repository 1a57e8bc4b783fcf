"""Default device and dtype of the port.

The JAX package picks f64 under x64 (the CPU tests) and f32 otherwise (the
TPU).  The port decides from the device instead: float64 on the CPU, to
match the tests' x64 reference, and float32 on CUDA.  Callers pass both
explicitly wherever a tensor is made, since torch defaults to float32.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
