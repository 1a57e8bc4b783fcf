"""Utilities of the port: profiling hooks, multi-process start-up, cost metrics."""
from .profiling import trace, lowered_cost
from .distributed import initialize_distributed
