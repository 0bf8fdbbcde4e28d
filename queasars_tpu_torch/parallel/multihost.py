"""Multi-process initialization: one global population mesh across processes.

Counterpart of ``queasars_tpu/parallel/multihost.py``.  The reference
scales across machines through a dask scheduler and TCP workers
(SURVEY.md §2.3); the JAX package through JAX's multi-controller runtime.
The port joins every process to one ``torch.distributed`` process group on
the ``gloo`` backend: each process runs the same solve on the same host
data, runs only its own blocks of the population, and the blocks' outputs
are all-gathered through host tensors (``parallel/mesh.py``).  gloo rather
than NCCL, because the outputs are small (energies [P], angles [P, S, 3])
and go to numpy anyway, and because NCCL refuses two processes on one GPU.

Usage (the same program in every process)::

    from queasars_tpu_torch.parallel import initialize_multihost, population_mesh

    initialize_multihost(coordinator_address="host0:29500",
                         num_processes=4, process_id=RANK)
    mesh = population_mesh()            # every process's devices, in rank order
    ...EVQEMinimumEigensolverConfiguration(mesh=mesh, ...)

Under ``torchrun`` the three arguments come from its environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): call
``initialize_multihost()`` with no arguments.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch.distributed as dist

#: how long a collective waits for the other processes
TIMEOUT = timedelta(minutes=10)

#: the process's local devices, as ``initialize_multihost`` was given them
_local_device_ids: Optional[list[int]] = None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list[int]] = None,
) -> None:
    """Join this process to the global process group (``gloo``).

    :param coordinator_address: ``host:port`` of process 0 (None: the
        ``MASTER_ADDR``/``MASTER_PORT`` environment)
    :param num_processes: the number of processes (None: ``WORLD_SIZE``)
    :param process_id: this process's rank (None: ``RANK``)
    :param local_device_ids: the CUDA device indices this process
        contributes to :func:`~queasars_tpu_torch.parallel.mesh.population_mesh`'s
        default (None: every visible card)
    """
    global _local_device_ids

    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=TIMEOUT,
    )
    _local_device_ids = None if local_device_ids is None else [int(i) for i in local_device_ids]


def local_device_ids() -> Optional[list[int]]:
    """The CUDA device indices given to :func:`initialize_multihost` (None:
    every visible card)."""
    return _local_device_ids


def is_multihost() -> bool:
    """True when more than one process has joined the process group."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> tuple[int, int]:
    """(process_id, process_count) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
