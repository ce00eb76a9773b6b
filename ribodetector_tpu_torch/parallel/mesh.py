"""Device meshes, rank grids and batch splits.

Counterpart of ``ribodetector_tpu/parallel/mesh.py``. The JAX package lays
its local devices out on a ``jax.sharding.Mesh`` and lets XLA place the
shards; here a mesh is the same layout over a list of devices (the visible
CUDA cards, or an explicit list, e.g. CPU replicas in a test) or over the
ranks of a ``torch.distributed`` group, one process per card. A process
finds its place on a (dp, tp) rank grid with ``make_grid``, which also
forms the dp and tp sub-groups of the default group.

Placement is JAX's: ``np.asarray(devices).reshape(n // tp, tp)`` puts
device (or rank) r at dp = r // tp, tp = r % tp. ``batch_sharded`` is the
row split of ``PartitionSpec(axis)``: part i of a b-row batch is the
contiguous slice [i * b / n, (i + 1) * b / n).
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Mesh:
    """Devices (or ranks) laid out on named axes, as jax.sharding.Mesh."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def local_devices():
    """The visible CUDA cards, as torch devices."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _first(num_devices, devices):
    devices = local_devices() if devices is None else list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devices)} local device(s) are visible"
            )
        devices = devices[:num_devices]
    return devices


def _grid(devices, shape):
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def make_data_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first num_devices) of `devices` (default:
    the visible CUDA cards): axis "data"."""
    devices = _first(num_devices, devices)
    return Mesh(_grid(devices, (len(devices),)), ("data",))


def make_dp_tp_mesh(num_devices: int | None = None, tp: int = 2,
                    devices=None) -> Mesh:
    """2-D (dp, tp) mesh over `devices` (see make_data_mesh); tp falls back
    to 1 if it does not divide the count."""
    devices = _first(num_devices, devices)
    n = len(devices)
    if n % tp != 0:
        tp = 1
    return Mesh(_grid(devices, (n // tp, tp)), ("dp", "tp"))


@dataclass(frozen=True)
class RowSplit:
    """Which rows of a batch each of `parts` shards holds: contiguous,
    equal slices (parts = 1: every shard holds the whole batch)."""

    parts: int

    def rows(self, b: int, i: int) -> slice:
        if self.parts == 1:
            return slice(0, b)
        if b % self.parts:
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{self.parts} equal shards")
        step = b // self.parts
        return slice(i * step, (i + 1) * step)

    def __call__(self, x, i: int):
        return x[self.rows(len(x), i)]


def replicated(mesh: Mesh) -> RowSplit:
    return RowSplit(1)


def batch_sharded(mesh: Mesh, axis: str = "data") -> RowSplit:
    """Shard the leading (batch) dimension over the given mesh axis."""
    return RowSplit(mesh.shape[axis])


@dataclass(frozen=True)
class Grid:
    """This process's place on a (dp, tp) grid of the ranks of the default
    process group: its rank, its coordinates and the two sub-groups it
    belongs to (the ranks that share its tp index, and those that share
    its dp index)."""

    mesh: Mesh
    rank: int
    dp_group: object
    tp_group: object

    @property
    def dp(self) -> int:
        return self.mesh.devices.shape[0]

    @property
    def tp(self) -> int:
        return self.mesh.devices.shape[1]

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp


def make_grid(tp: int) -> Grid:
    """The (dp, tp) grid over every rank of the initialized default
    process group (make_dp_tp_mesh over the ranks: tp falls back to 1 when
    it does not divide the world size). Every rank must call it, in the
    same order as its other collectives: it forms the sub-groups."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_dp_tp_mesh(tp=tp, devices=range(world))
    ranks = mesh.devices.astype(int)
    tp_group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    dp_group, _ = dist.new_subgroups_by_enumeration(ranks.T.tolist())
    return Grid(mesh, rank, dp_group, tp_group)
