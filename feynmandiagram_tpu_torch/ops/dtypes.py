"""Default device and dtype of the port.

The JAX package picks f64 under x64 (the CPU tests) and f32 otherwise (the
TPU).  The port's entry points run on the card: ``default_device`` is CUDA
and raises where there is none, so that nothing carries on on the CPU
unasked.  A caller that wants the CPU passes ``device="cpu"``, as the tests
do.  The dtype follows the device: float64 on the CPU, to match the tests'
x64 reference, and float32 on CUDA.  Callers pass both explicitly wherever
a tensor is made, since torch defaults to float32.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device; raises ``RuntimeError`` where CUDA is not available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "feynmandiagram_tpu_torch runs on a CUDA device and "
            "torch.cuda.is_available() is false; pass device='cpu' to run on the "
            "CPU on purpose")
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
