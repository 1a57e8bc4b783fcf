"""LoopPool: deduplicated basis of internal/external momentum loops.

A loop variable is a linear combination of independent loop momenta:
``loops[:, i] = variable @ basis[:, i]``.  On TPU the update is a single
batched matmul inside the jitted evaluation step (see ops.leaf_eval);
this host-side class manages basis construction and deduplication.

Reference: FeynmanDiagram.jl/src/frontend/pool.jl.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class LoopPool:
    def __init__(self, name: str, dim: int, loop_num_or_basis, dtype=np.float64):
        self.name = name
        self.dim = dim
        if isinstance(loop_num_or_basis, int):
            self.loop_num = loop_num_or_basis
            self.basis = np.zeros((self.loop_num, 0), dtype)  # loopNum x N
            self.loops = np.zeros((dim, 0), dtype)            # dim x N
        else:
            basis = [np.asarray(b, dtype) for b in loop_num_or_basis]
            if not basis:
                raise ValueError("basis must be non-empty")
            self.loop_num = len(basis[0])
            if not all(len(b) == self.loop_num for b in basis):
                raise ValueError("all basis vectors must have equal length")
            self.basis = np.stack(basis, axis=1)
            self.loops = np.empty((dim, self.basis.shape[1]), dtype)

    def __len__(self) -> int:
        return self.basis.shape[1]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.basis[:, i]

    def __setitem__(self, i: int, v) -> None:
        self.basis[:, i] = v

    def update(self, variable: Optional[np.ndarray] = None) -> np.ndarray:
        """loops = variable[:, :loop_num] @ basis — one matmul (pool.jl:69-76)."""
        if variable is None:
            variable = np.random.rand(self.dim, self.loop_num)
        variable = np.asarray(variable)
        if variable.shape[0] != self.dim:
            raise ValueError(f"variable dim {variable.shape[0]} != pool dim {self.dim}")
        self.loops = variable[:, :self.loop_num] @ self.basis
        return self.loops

    def loop(self, idx: int) -> np.ndarray:
        return self.loops[:, idx]

    def has_loop(self) -> bool:
        return self.dim > 0 and self.loop_num > 0

    def append(self, basis: Sequence[float]) -> int:
        """Append a basis vector, deduplicating by ≈; returns its 0-based index
        (pool.jl:82-99)."""
        basis = np.asarray(basis, self.basis.dtype)
        if self.loop_num < len(basis):
            raise ValueError("basis longer than loop_num")
        if self.loop_num > len(basis):
            basis = np.concatenate([basis, np.zeros(self.loop_num - len(basis), basis.dtype)])
        for bi in range(len(self)):
            if np.allclose(self.basis[:, bi], basis, rtol=1.49e-8):
                return bi
        self.basis = np.concatenate([self.basis, basis[:, None]], axis=1)
        self.loops = np.concatenate([self.loops, np.random.rand(self.dim, 1)], axis=1)
        return len(self) - 1
