"""Utilities of the port: multi-process start-up.

The JAX package's ``trace`` and ``lowered_cost`` (``utils/profiling.py``)
are not ported yet.
"""
from .distributed import initialize_distributed
