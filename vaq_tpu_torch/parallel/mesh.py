"""Device meshes for the sharded search.

The counterpart of ``vaq_tpu/parallel/mesh.py``, with its axis convention:

* ``"db"`` — database rows (the scale axis: code rows, decoded rows and
  probe clusters are split along it, and the per-shard top-k merge rides
  it);
* ``"q"``  — the query batch (data parallel), an optional second axis.

A JAX mesh is a grid of distinct devices. The port's :class:`Mesh` is a grid
of ``torch.device``\\ s in which **a device may repeat**:
``make_mesh(devices=["cpu"] * 8)`` gives eight shards on the CPU (how the
tests run eight shards), ``[torch.device("cuda", 0)] * S`` S shards on one
card. Shards on one device run one after another on its current stream.

A mesh may carry a ``torch.distributed`` process group. One axis
(``group_axis``, ``"db"`` by default) then extends over the group's ranks:
each rank holds ``devices`` as its part of the grid, and the global index
along that axis is ``rank · local size + local index``. The sharded
functions then take one more step across the group (an ``all_gather`` of
the per-shard top-k rows, of the k-means sums) — see ``sharded.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vaq_tpu_torch.device import resolve
from vaq_tpu_torch.errors import ConfigError, DeviceError


class Mesh:
    """A grid of torch devices with named axes (devices may repeat).

    ``devices`` is this process's part of the grid, an object array of
    ``torch.device`` shaped like ``axis_names``; ``group`` a process group
    over which ``group_axis`` extends, or None for one process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 group=None, group_axis: str = "db"):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names) or \
                not set(self.axis_names) <= {"db", "q"} or \
                "db" not in self.axis_names:
            raise ConfigError(
                f"a mesh has the axis 'db' and optionally 'q', one grid "
                f"dimension each; got {self.axis_names} over a grid of "
                f"shape {devices.shape}")
        if group is not None and group_axis not in self.axis_names:
            raise ConfigError(f"group axis {group_axis!r} is not an axis of "
                              f"{self.axis_names}")
        self.group = group
        self.group_axis = group_axis

    @property
    def world(self) -> int:
        """Ranks of the process group (1 without one)."""
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def shape(self) -> dict:
        """Global size of each axis (the group's ranks included), as JAX's
        ``mesh.shape``."""
        out = dict(zip(self.axis_names, self.devices.shape))
        if self.group is not None:
            out[self.group_axis] *= self.world
        return out

    def offset(self, axis: str) -> int:
        """Global index of this rank's first entry along ``axis``."""
        if self.group is None or axis != self.group_axis:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group) * \
            self.devices.shape[self.axis_names.index(axis)]

    def rows(self, axis: str = "db") -> np.ndarray:
        """This rank's grid as (rows, local size along ``axis``): row r is
        the r-th entry of the other axis ("q"), one row on a 1-D mesh."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return grid.reshape(-1, grid.shape[-1])


def _device_grid(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    need = int(np.prod(shape))
    if len(devices) < need:
        raise ConfigError(f"mesh shape {shape} needs {need} devices, "
                          f"got {len(devices)}")
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i] = resolve(d)
    return grid.reshape(shape)


def local_cuda_devices() -> list:
    """Every visible CUDA device; DeviceError without a card (no CPU
    fallback)."""
    if not torch.cuda.is_available():
        raise DeviceError(
            "make_mesh() spans the visible CUDA devices but "
            "torch.cuda.is_available() is false; pass devices=['cpu'] * n "
            "to shard on the CPU, as device='cpu' places an index there")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("db",),
    devices: Optional[Sequence] = None,
    group=None,
) -> Mesh:
    """Build a mesh over the given devices (every visible card by default).

    With no arguments, all cards go to a 1-D "db" mesh. Pass
    ``shape=(q, db)`` + ``axis_names=("q", "db")`` for 2-D query×database
    sharding. ``devices`` may repeat a device (several shards on one). With
    ``group``, the "db" axis extends over the group's ranks, each passing
    its own devices."""
    if devices is None:
        devices = local_cuda_devices()
    if shape is None:
        shape = (len(devices),)
    return Mesh(_device_grid(list(devices), tuple(shape)), axis_names, group)
