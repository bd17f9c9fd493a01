"""Device meshes for the distributed solve (port of
ar_slam_tpu/parallel/mesh.py).

The scaling axis is the tag (landmark) axis with its observations: per-tag
Schur blocks are independent sums over that tag's observations, so they
shard across devices and the capture-side normal equations reduce over
the shards.  Camera and capture poses are small and stay replicated.

A ``Mesh`` is the ordered list of this process's shard devices, the axis
name and the process group (or None for one process).  A device may
repeat: the CPU tests shard over ``[cpu] * 8`` and one card can hold
several shards (``[cuda:0] * k``), which run one after another on its
stream; that is correct and not a speedup.  With a process group every
process holds the same number of shards, and the global shard count is
that times the world size.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BLOCK_AXIS = "blocks"


class Sharded(list):
    """One tensor per local shard, in shard order.  ``+`` adds shard by
    shard (the LM loop's parameter update)."""

    def __add__(self, other):
        return Sharded(a + b for a, b in zip(self, other))


class Mesh:
    """A 1-D mesh: this process's shard devices, the axis name, the
    process group (None without torch.distributed) and a count of the
    reductions run over it (``dist_lm._psum_packed``)."""

    def __init__(self, devices, axis_name: str = BLOCK_AXIS, group=None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.axis_name = axis_name
        self.group = group
        self.world = 1
        self.rank = 0
        if group is not None:
            self.world = group.size()
            self.rank = group.rank()
        self.reductions = 0

    @property
    def home(self) -> torch.device:
        """The device that holds the replicated values: the first shard's."""
        return self.devices[0]

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """The global shard count."""
        return self.n_local * self.world

    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_name!r}, world={self.world})")


def _group():
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() \
        else None


def local_shards(group=None) -> tuple[int, int]:
    """(this process's index among the processes on its host, the CUDA
    devices each of them takes by default): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else the global rank and world size (every process
    on one host)."""
    rank = 0 if group is None else group.rank()
    world = 1 if group is None else group.size()
    lr = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return lr, max(torch.cuda.device_count() // local_world, 1)


def block_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """1-D mesh over the block axis.

    ``devices`` lists this process's shard devices (repeats allowed).
    Otherwise ``n_devices`` global shards go on CUDA devices: with one
    process the first ``n_devices`` cards, with a process group
    ``n_devices / world`` cards a process, each process taking its own
    consecutive cards.  Asking for more cards than there are builds the
    mesh of them all, as the reference's ``devices[:n]`` does.  Default:
    every card, or with a process group each process's share of its
    host's cards."""
    group = _group()
    if devices is not None:
        return Mesh(devices, group=group)
    world = 1 if group is None else group.size()
    lr, per_process = local_shards(group)
    if n_devices is None or n_devices > per_process * world:
        n_devices = per_process * world
    if n_devices % world:
        raise ValueError(f"{n_devices} shards do not divide over {world} "
                         "processes")
    k = n_devices // world
    count = torch.cuda.device_count()
    if (lr + 1) * k > count:
        raise ValueError(
            f"a mesh of {n_devices} shards needs CUDA devices "
            f"{lr * k}..{(lr + 1) * k - 1} in this process; "
            f"torch.cuda.device_count() is {count}")
    return Mesh([torch.device("cuda", lr * k + i) for i in range(k)],
                group=group)


def device_mesh(n_shards: int, device) -> Mesh:
    """A block mesh of ``n_shards`` global shards on ``device``'s kind:
    CUDA cards (``block_mesh``), or shards of the one CPU repeated,
    ``n_shards / world`` a process."""
    device = torch.device(device)
    if device.type == "cuda":
        return block_mesh(n_shards)
    group = _group()
    world = 1 if group is None else group.size()
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not divide over {world} "
                         "processes")
    return block_mesh(devices=[device] * (n_shards // world))


def pad_blocks_to_multiple(arrs_dict: dict, n: int) -> dict:
    """Pad every block-axis array so the axis divides the mesh size."""
    b = arrs_dict["cap_idx"].shape[0]
    rem = (-b) % n
    if rem == 0:
        return dict(arrs_dict)
    out = {}
    for k, v in arrs_dict.items():
        pad_width = [(0, rem)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out


def _tensor(a, device, dtype=None):
    """A copy of numpy ``a`` on ``device`` (the caller may mutate ``a``
    later): floats in ``dtype`` when given, integers as int64."""
    a = np.asarray(a)
    if dtype is not None and np.issubdtype(a.dtype, np.floating):
        return torch.tensor(a, device=device, dtype=dtype)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def shard_blocks(mesh: Mesh, *arrays, dtype=None):
    """Split each array's leading axis into ``mesh.n_shards`` equal parts
    and place this process's parts on their shard devices: one
    ``Sharded`` per array.  Float arrays take ``dtype`` when given,
    integer arrays become int64."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        per = a.shape[0] // mesh.n_shards
        if per * mesh.n_shards != a.shape[0]:
            raise ValueError(f"leading axis {a.shape[0]} does not divide "
                             f"into {mesh.n_shards} shards")
        out.append(Sharded(
            _tensor(a[g * per:(g + 1) * per], dev, dtype)
            for g, dev in zip(mesh.shard_ids(), mesh.devices)))
    return tuple(out)


def replicate(mesh: Mesh, *arrays, dtype=None):
    """Place each host array on the mesh's home device (float arrays in
    ``dtype`` when given)."""
    return tuple(_tensor(a, mesh.home, dtype) for a in arrays)
