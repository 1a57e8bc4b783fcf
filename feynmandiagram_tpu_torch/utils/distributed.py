"""Multi-process start-up on ``torch.distributed``.

Port of ``feynmandiagram_tpu/utils/distributed.py``.  Each process calls
``initialize_distributed`` before it builds a mesh that spans processes
(``parallel.Mesh`` with a process group on an axis); ``make_sample_mesh``
then spans the default group.  NCCL joins the processes when they run on
CUDA, gloo on the CPU.  NCCL takes one process per card, so several ranks
on one card are a local mesh axis in one process, not processes.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.dtypes import default_device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device=None) -> None:
    """Join this process to the default process group.

    ``coordinator_address`` is an ``init_method`` URL (``file:///path`` or
    ``tcp://host:port``; a bare ``host:port`` means ``tcp://``),
    ``num_processes`` the world size and ``process_id`` this process's rank.
    With none of the three and neither ``MASTER_ADDR`` nor ``WORLD_SIZE`` in
    the environment there is nothing to join: the call returns and does
    nothing.  With none of the three but the environment set, the group
    starts from it (``env://``).  ``device`` (default: the CUDA card, which
    raises where there is none) picks the backend: NCCL for CUDA, gloo for
    the CPU.

    Once anything is configured, every error raises.  The JAX package's
    version swallows every error of its automatic path and carries on as a
    single process; this one does not, so that a misconfigured job never
    runs as one process unnoticed.
    """
    if coordinator_address is None and num_processes is None and process_id is None:
        if "MASTER_ADDR" not in os.environ and "WORLD_SIZE" not in os.environ:
            return
        init_method = "env://"
    elif coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, num_processes "
                         "and process_id together")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    device = torch.device(device) if device is not None else default_device()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method == "env://":
        dist.init_process_group(backend, init_method=init_method)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id)
