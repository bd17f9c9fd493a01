"""Data-parallel marker detection over a device mesh (port of
ar_slam_tpu/parallel/detect.py).

The whole detector is one batched device program (detect/detect.py), so
the scaling axis is the IMAGE axis: the batch splits over the mesh's
shards and each runs the unchanged ``detect_batch`` (K1-K4 at its
shard's local shapes) on its contiguous slice: on the card it replays
the detector's CUDA graph, the counterpart of the reference's jitted
``shard_map`` (ar_slam_tpu/parallel/detect.py:61).  The shards get equal
slices after padding, so the shards of one card share one program,
replayed once a shard, and each card of the mesh captures its own (a
graph records on one card).  Under a process group
(``--multihost``) the mesh spans every process's shards, as the
reference's image mesh spans every process's devices: each process
detects its own shards' slices, and one all-gather gives every process
the whole batch's detections.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch.detect.detect import (DetectParams, batch_shape,
                                             detect_batch)
from ar_slam_tpu_torch.parallel.mesh import Mesh, block_mesh, device_mesh

IMAGE_AXIS = "images"


def image_mesh(n_devices: int | None = None, *, devices=None,
               device="cuda") -> Mesh:
    """1-D mesh over the image (batch) axis, placed as ``block_mesh``
    places its shards: ``devices`` (this process's, repeats allowed), or
    ``n_devices`` global shards on ``device``'s kind: CUDA cards (default:
    all; more than there are build the mesh of them all, as the
    reference's ``devices[:n]`` does), or the one CPU repeated, ``n /
    world`` shards a process.  Under a process group the mesh spans every
    process."""
    if devices is None and torch.device(device).type != "cuda":
        mesh = device_mesh(n_devices or 1, device)
    else:
        mesh = block_mesh(n_devices, devices=devices)
    mesh.axis_name = IMAGE_AXIS
    return mesh


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The processes' ``x`` (equal shapes) concatenated in rank order."""
    import torch.distributed as dist

    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(parts, wire.contiguous(), group=mesh.group)
    return torch.cat(parts).to(x.dtype)


def detect_batch_sharded(images, *, mesh: Mesh,
                         params: DetectParams = DetectParams(),
                         dict_names=("4X4_50", "5X5_100"),
                         gather: bool = True, graphs: bool = True,
                         pad_to=None):
    """detect_batch with the image axis split over ``mesh``.

    Args:
      images: (N, H, W) grayscale, numpy or torch, or a sequence of N
        (H, W) host arrays (``detect_batch``'s), the whole batch (every
        process of a process group passes the same).  N (or ``pad_to``,
        where larger) is padded up to a multiple of the global shard count
        with zero images (their detections are all invalid), each shard's
        by its own ``detect_batch`` call, and the padding is stripped from
        every output.
      gather: concatenate the shards' outputs on the mesh's first device
        (the same dict as detect_batch, leading axis N), over every
        process of a process group; False keeps this process's shards'
        outputs, on each shard's device: a list of dicts, leading axes
        each shard's share of the N images.
      graphs: ``detect_batch``'s, for every shard.
    """
    shape, dtype = batch_shape(images)
    n = shape[0]
    per = -(-max(n, pad_to or 0) // mesh.n_shards)
    # a shard past the images gets an empty batch: all padding
    empty = torch.empty((0, *shape[1:]), dtype=dtype)
    parts = [images[g * per:(g + 1) * per] for g in mesh.shard_ids()]
    outs = [detect_batch(part if len(part) else empty, params=params,
                         dict_names=dict_names, device=dev, graphs=graphs,
                         pad_to=per)
            for part, dev in zip(parts, mesh.devices)]
    if not gather:
        keep = [min(per, max(n - g * per, 0)) for g in mesh.shard_ids()]
        return [{name: {key: v[:k] for key, v in d.items()}
                 for name, d in out.items()} for out, k in zip(outs, keep)]
    out = {}
    for name in dict_names:
        out[name] = {}
        for key in outs[0][name]:
            x = torch.cat([o[name][key].to(mesh.home) for o in outs])
            if mesh.world > 1:
                x = _all_gather(x, mesh)
            out[name][key] = x[:n]
    return out
