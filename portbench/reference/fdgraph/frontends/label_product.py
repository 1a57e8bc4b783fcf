"""LabelProduct: Cartesian product of label axes (τ index × loop-basis × …)
with linear <-> multi index maps.

Indices are 0-based (the reference LabelProduct.jl is 1-based Julia); the
first axis varies fastest, matching the reference's column-major layout.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


class LabelProduct:
    def __init__(self, *axes: Sequence):
        self.labels: List[list] = [list(v) for v in axes]
        self.dims: Tuple[int, ...] = tuple(len(v) for v in self.labels)

    @property
    def rank(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def size(self, i: int = None):
        return self.dims if i is None else self.dims[i]

    def index_to_linear(self, *I: int) -> int:
        """Multi-index (0-based) -> linear index (0-based); first axis fastest."""
        ex = I[-1]
        for i in range(len(I) - 2, -1, -1):
            ex = I[i] + self.dims[i] * ex
        return ex

    def linear_to_index(self, I: int) -> Tuple[int, ...]:
        out = []
        q = I
        for i in range(len(self.dims) - 1):
            out.append(q % self.dims[i])
            q //= self.dims[i]
        out.append(q)
        return tuple(out)

    def __getitem__(self, index):
        if isinstance(index, int):
            index = self.linear_to_index(index)
        return tuple(self.labels[i][j] for i, j in enumerate(index))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def push_labelat(self, new_label, dim: int) -> int:
        """Add (or find) ``new_label`` on axis ``dim``; returns its 0-based
        index (LabelProduct.jl:140-149)."""
        try:
            return self.labels[dim].index(new_label)
        except ValueError:
            self.labels[dim].append(new_label)
            self.dims = tuple(d + 1 if i == dim else d for i, d in enumerate(self.dims))
            return self.dims[dim] - 1

    def append_label(self, new_label: Sequence) -> Tuple[int, ...]:
        """Add (or find) one label per axis; returns their indices
        (LabelProduct.jl:151-170)."""
        if len(new_label) != self.rank:
            raise ValueError("new_label length must match the number of axes")
        return tuple(self.push_labelat(lab, dim) for dim, lab in enumerate(new_label))

    def __repr__(self) -> str:
        return f"LabelProduct of: {self.labels}"
