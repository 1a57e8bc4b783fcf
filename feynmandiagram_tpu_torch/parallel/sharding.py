"""Device meshes and sample-axis data parallelism, on ``torch.distributed``.

Port of ``feynmandiagram_tpu/parallel/sharding.py``.  ``Mesh`` stands in for
``jax.sharding.Mesh``: named axes with sizes, one device, and for each axis
the ranks that this process holds.

- A *local* axis has all its ranks in this process, on its one device.  That
  is the counterpart of the JAX tests' virtual-device mesh, and how one card
  runs a 4-rank or a 4 x 2 mesh: NCCL takes one process per card.
- A *distributed* axis spans the processes of a ``torch.distributed``
  group (gloo on the CPU, NCCL on cards); each process holds an equal,
  contiguous block of its ranks, process ``p`` the ranks ``p * k ..
  p * k + k - 1``.

A process steps the ranks it holds one after the other; a collective along
an axis takes one tensor from each of them.  The layer's two collectives are
``all_gather`` and ``mean``.  Sample-axis parallelism is as in the JAX
package: the batch is split over the axis, the lowered graph's tables are
shared, and the estimator means reduce with one ``mean`` over the axis.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.dtypes import default_device, default_dtype

BATCH_AXIS = "batch"


def _all_gather_into_tensor(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # newer torch calls all_gather_into_tensor deprecated in favour of
    # all_gather_single, which older releases lack; the call is the same
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*deprecated")
        dist.all_gather_into_tensor(out, inp, group=group)


class Mesh:
    """Named axes, one device, and per axis the ranks this process holds.

    ``axes`` is a sequence of ``(name, size)``; ``groups`` maps the name of
    each distributed axis to its process group (``dist.group.WORLD`` for the
    default group), whose size must divide the axis's.  Every other axis is
    local.  ``shape`` maps names to sizes, as ``jax.sharding.Mesh.shape``.
    """

    def __init__(self, axes: Sequence[Tuple[str, int]], *, device=None,
                 groups: Optional[Dict[str, object]] = None):
        self.device = torch.device(device) if device is not None else default_device()
        self.shape = {name: int(size) for name, size in axes}
        self._groups = dict(groups or {})
        unknown = set(self._groups) - set(self.shape)
        if unknown or len(self.shape) != len(axes):
            raise ValueError(f"axes {axes}: repeated names, or groups for unknown axes "
                             f"{sorted(unknown)}")
        self._local: Dict[str, range] = {}
        for name, size in self.shape.items():
            if size < 1:
                raise ValueError(f"axis {name!r} has size {size}")
            if name not in self._groups:
                self._local[name] = range(size)
                continue
            group = self._groups[name]
            world = dist.get_world_size(group)
            if size % world:
                raise ValueError(f"axis {name!r} of size {size} does not divide over "
                                 f"{world} processes")
            k, p = size // world, dist.get_rank(group)
            self._local[name] = range(p * k, p * k + k)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def local_ranks(self, axis: str) -> range:
        """The ranks of ``axis`` that this process holds."""
        return self._local[axis]

    def is_local(self, axis: str) -> bool:
        return axis not in self._groups

    def all_gather(self, axis: str, blocks: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """Concatenate one block per rank of ``axis`` along ``dim``, in rank
        order.  ``blocks`` holds this process's ranks' blocks, in the order
        of ``local_ranks``; every block has one shape.  Each process gets
        the whole result."""
        blocks = list(blocks)
        if len(blocks) != len(self._local[axis]):
            raise ValueError(f"{len(blocks)} blocks for the {len(self._local[axis])} ranks "
                             f"of {axis!r} held here")
        mine = torch.cat(blocks, dim=dim) if len(blocks) > 1 else blocks[0]
        if self.is_local(axis):
            return mine
        group = self._groups[axis]
        world = dist.get_world_size(group)
        mine = mine.movedim(dim, 0).contiguous()
        out = torch.empty((world * mine.shape[0],) + tuple(mine.shape[1:]),
                          dtype=mine.dtype, device=mine.device)
        _all_gather_into_tensor(out, mine, group)
        return out.movedim(0, dim)

    def mean(self, axis: str, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """The mean over the ranks of ``axis`` of one tensor per rank:
        ``values`` in the order of ``local_ranks``.  The values of all ranks
        are gathered and added in rank order, then divided by the axis's
        size, so the result has the same bits whichever ranks a process
        holds."""
        stacked = self.all_gather(axis, [v.unsqueeze(0) for v in values])
        total = stacked[0]
        for row in stacked[1:]:
            total = total + row
        return total / self.shape[axis]


def make_sample_mesh(n_devices: Optional[int] = None, *, axis_name: str = BATCH_AXIS,
                     device=None, group=None) -> Mesh:
    """A 1-D mesh over the Monte-Carlo sample axis.

    Over ``group`` if one is given, else over the default process group
    where ``torch.distributed`` is initialised: ``n_devices`` ranks in all
    (default: one per process).  Otherwise local, with ``n_devices`` ranks
    (default 1) in this process."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        size = n_devices if n_devices is not None else dist.get_world_size(group)
        return Mesh([(axis_name, size)], device=device, groups={axis_name: group})
    return Mesh([(axis_name, n_devices or 1)], device=device)


def _rank_columns(batch: int, mesh: Mesh, axis: str) -> List[slice]:
    """The columns of each rank of ``axis`` held here: equal contiguous
    shards of ``batch``, which must divide by the axis's size."""
    n = mesh.shape[axis]
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over the {n} ranks of {axis!r}")
    per = batch // n
    return [slice(r * per, (r + 1) * per) for r in mesh.local_ranks(axis)]


def shard_compiled(compiled, mesh: Mesh, *, axis_name: str = BATCH_AXIS):
    """``f(varK, varT) -> roots[R, batch]`` with the batch split over
    ``axis_name``: each rank runs ``compiled`` (a ``CompiledEvaluator``) on
    its columns, and the roots are gathered.  Every process passes the whole
    batch and gets all of the roots.  The batch must divide by the axis's
    size."""
    def fn(varK, varT) -> torch.Tensor:
        varK = torch.as_tensor(varK, device=mesh.device)
        varT = torch.as_tensor(varT, device=mesh.device)
        parts = [compiled.graph_fn(compiled.leaf_fn(varK[..., cols].contiguous(),
                                                    varT[:, cols].contiguous()))
                 for cols in _rank_columns(varT.shape[-1], mesh, axis_name)]
        return mesh.all_gather(axis_name, parts, dim=1)

    return fn


def rank_seed(seed: int, *ranks: int) -> int:
    """The seed of the ``torch.Generator`` of one rank (and iteration):
    ``np.random.SeedSequence([seed, *ranks]).generate_state(1, np.uint64)[0]``."""
    return int(np.random.SeedSequence([seed, *ranks]).generate_state(1, np.uint64)[0])


def make_mc_step(compiled, mesh: Mesh, *, beta: float, axis_name: str = BATCH_AXIS):
    """One Monte-Carlo estimation step, data-parallel over ``axis_name``.

    Returns ``step(seed, batch_per_device) -> means[R]``.  Rank ``r`` of the
    axis draws from a ``torch.Generator`` on the mesh's device seeded with
    ``rank_seed(seed, r)``: ``varK`` ``[3, max_loop, batch_per_device]``
    normal, then ``varT`` ``[num_tau, batch_per_device]`` uniform times
    ``beta`` (the order of ``mc.mc_run``).  It evaluates its samples, sums
    each root over them and divides by ``batch_per_device``; ``mean``
    reduces the ranks' estimates over the axis.  The samples are float32 on
    CUDA and float64 on the CPU.  The JAX version takes a PRNG key; the two
    generators differ anyway.
    """
    tables = compiled.tables
    max_loop = compiled.max_loop_num
    num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
    dtype = default_dtype(mesh.device)

    def step(seed: int, batch_per_device: int) -> torch.Tensor:
        means = []
        for r in mesh.local_ranks(axis_name):
            gen = torch.Generator(device=mesh.device)
            gen.manual_seed(rank_seed(seed, r))
            vk = torch.randn((3, max_loop, batch_per_device), generator=gen, dtype=dtype,
                             device=mesh.device)
            vt = torch.rand((num_tau, batch_per_device), generator=gen, dtype=dtype,
                            device=mesh.device) * beta
            roots = compiled.graph_fn(compiled.leaf_fn(vk, vt))
            means.append(roots.sum(dim=1) / batch_per_device)
        return mesh.mean(axis_name, means)

    return step
