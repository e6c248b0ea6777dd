"""Multi-process initialization + pod-mesh helpers.

The counterpart of ``vaq_tpu/parallel/multihost.py``. Each process runs the
same program; ``initialize_distributed`` joins them into one
``torch.distributed`` process group (NCCL between cards, gloo on the CPU),
and ``pod_mesh`` builds the serving mesh over it:

* ``"db"`` (database rows) stays on each process's own devices when the
  query stream is split over the processes (``q_hosts=True``), so the
  hot-path merge never crosses processes;
* ``"q"`` (query data parallelism) maps to the processes.

Nothing on a machine tells a program of a cluster: the address, the world
size and the rank come from the arguments, or from the launcher's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` environment.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from vaq_tpu_torch.parallel.mesh import (Mesh, _device_grid,
                                         local_cuda_devices, make_mesh)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the process group (no-op in a single process or when joined).

    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``tcp://…``, ``file://…``), with ``num_processes`` and ``process_id``;
    without it the launcher's environment (``WORLD_SIZE`` > 1, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is read. NCCL when a card is visible,
    gloo otherwise."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return  # single process: nothing to join
        init_method, num_processes = "env://", world
        process_id = int(os.environ["RANK"])
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def pod_mesh(q_hosts: bool = True, devices: Optional[Sequence] = None
             ) -> Tuple[Mesh, Optional[str]]:
    """Build the serving mesh for the current topology over this process's
    ``devices`` (every visible card by default).

    With q_hosts=True and more than one process: ("q", "db") with q = the
    process count and db = each process's devices. Otherwise a flat ("db",)
    mesh over every process's devices. Returns (mesh, q_axis) suitable for
    ``VAQIndex.shard``."""
    import torch.distributed as dist

    local = list(devices) if devices is not None else local_cuda_devices()
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return make_mesh(devices=local), None
    group = dist.group.WORLD
    if q_hosts:
        grid = _device_grid(local, (1, len(local)))
        return Mesh(grid, ("q", "db"), group, group_axis="q"), "q"
    return Mesh(_device_grid(local, (len(local),)), ("db",), group), None
