"""Multi-process support for the distributed solver (port of
ar_slam_tpu/parallel/multihost.py).

Every process runs the same command over a global mesh and places data on,
and reads data from, only its own shards:

- ``initialize(spec, device)`` joins ``torch.distributed``:
  ``coordinator:port,num_processes,process_id`` (explicit, e.g. several
  processes on one machine) or ``auto`` (torchrun's environment
  variables).  The backend follows the device: NCCL for CUDA, gloo for
  the CPU.  NCCL takes one card a process, so two processes on one card
  are refused by NCCL itself;
- ``put_global(arr, mesh)``: this process's shards of a host array that
  every process holds in full (the host-side graph store is a pure
  function of the shared input detections);
- ``fetch(x, mesh)``: tensor or shards -> host numpy of the whole array;
  sharded state all-gathers across processes, once per solve, not once
  per iteration.

Every process must run the same sequence of reductions: the wave drivers
guarantee it, since the graph bookkeeping (BFS order, seed choice,
activity masks) is a pure function of the shared input and every host
decision of the LM loop reads values that the reductions made equal on
all processes.  Tested with two gloo processes of the ``arslam-torch``
command in tests/test_torch_multihost.py.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from ar_slam_tpu_torch.parallel.mesh import Mesh, Sharded, shard_blocks

__all__ = ["initialize", "put_global", "fetch", "is_multiprocess",
           "world_device_count"]

INIT_TIMEOUT_S = 600  # joining and every collective (torch.distributed)


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def put_global(arr, mesh: Mesh, dtype=None) -> Sharded:
    """This process's shards of ``arr`` (split along its leading axis)."""
    return shard_blocks(mesh, arr, dtype=dtype)[0]


def fetch(x, mesh: Mesh | None = None) -> np.ndarray:
    """Host numpy of a tensor, or of the whole array behind ``Sharded``
    shards (all-gathered across processes when there are several)."""
    if isinstance(x, np.ndarray):
        return x
    if not isinstance(x, Sharded):
        return x.detach().cpu().numpy()
    local = torch.cat([s.to(mesh.home) for s in x])
    if mesh.group is not None and mesh.world > 1:
        import torch.distributed as dist

        parts = [torch.empty_like(local) for _ in range(mesh.world)]
        dist.all_gather(parts, local, group=mesh.group)
        local = torch.cat(parts)
    return local.cpu().numpy()


def initialize(spec: str | None, device) -> tuple[int, int]:
    """Join the process group; returns (process index, process count).

    ``spec`` is ``coordinator:port,num_processes,process_id`` or
    ``auto``/None (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
    RANK, as torchrun sets them).  Call before any device use."""
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    if spec and spec != "auto":
        parts = spec.rsplit(",", 2)
        if len(parts) != 3:
            raise ValueError(
                "--multihost expects coordinator:port,num_processes,"
                f"process_id or 'auto'; got {spec!r}")
        coordinator, num, pid = parts[0], int(parts[1]), int(parts[2])
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num, rank=pid, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    if backend == "nccl":
        from ar_slam_tpu_torch.parallel.mesh import local_shards

        lr, per_process = local_shards(dist.group.WORLD)
        torch.cuda.set_device(lr * per_process)
    return dist.get_rank(), dist.get_world_size()


def world_device_count(device) -> int:
    """The global shard count by default: each process's share of its
    host's cards on CUDA (``mesh.local_shards``), one shard a process on
    the CPU."""
    import torch.distributed as dist

    from ar_slam_tpu_torch.parallel.mesh import local_shards

    world = dist.get_world_size() if dist.is_initialized() else 1
    if torch.device(device).type != "cuda":
        return world
    group = dist.group.WORLD if dist.is_initialized() else None
    return local_shards(group)[1] * world
