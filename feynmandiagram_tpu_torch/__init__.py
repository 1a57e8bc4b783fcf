"""feynmandiagram_tpu_torch: the PyTorch and CUDA port of feynmandiagram_tpu.

The host pipeline (front ends, graph IR, optimizer, ``ops/lowering.py``) is
the JAX package's own, imported through ``_host`` without jax.  The device
side is ported: ``ops`` (leaf phase, graph phase, the hand-written CUDA
bucket kernel and the kernels' build), ``models`` (G and V physics),
``backends.compile`` (the whole pipeline and the ``.npz`` artifacts),
``mc`` (the Monte-Carlo throughput protocol) and ``benchmarks`` (the
row-access probes, nine hand-written CUDA kernels, and the gather probe).  Module names mirror the JAX package's.
"""
__version__ = "0.1.0"
