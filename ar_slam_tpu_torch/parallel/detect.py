"""Data-parallel marker detection over a device mesh (port of
ar_slam_tpu/parallel/detect.py).

The whole detector is one batched device program (detect/detect.py), so
the scaling axis is the IMAGE axis: the batch splits over the mesh's
devices and each runs the unchanged ``detect_batch`` (K1-K4 at its
shard's local shapes) on its slice.  Detection is embarrassingly
data-parallel: no reduction, no process group.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch.detect.detect import DetectParams, detect_batch
from ar_slam_tpu_torch.parallel.mesh import Mesh

IMAGE_AXIS = "images"


def image_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """1-D mesh over the image (batch) axis: ``devices`` (repeats allowed)
    or the first ``n_devices`` CUDA cards (default: all); more cards than
    there are raise."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 0 < n <= count:
            raise ValueError(f"an image mesh of {n} devices: "
                             f"torch.cuda.device_count() is {count}")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices, axis_name=IMAGE_AXIS)


def detect_batch_sharded(images, *, mesh: Mesh,
                         params: DetectParams = DetectParams(),
                         dict_names=("4X4_50", "5X5_100"),
                         gather: bool = True):
    """detect_batch with the image axis split over ``mesh``.

    Args:
      images: (N, H, W) grayscale, numpy or torch.  N is padded up to a
        multiple of the shard count with zero images (their detections
        are all invalid), and the padding is stripped from every output.
      gather: concatenate the shards' outputs on the mesh's first device
        (the same dict as detect_batch, leading axis N); False keeps them
        per shard, on each shard's device: a list of dicts whose leading
        axes sum to N.
    """
    frames = torch.as_tensor(images)
    n = frames.shape[0]
    k = mesh.n_local
    per = -(-n // k)
    pad = per * k - n
    if pad:
        frames = torch.cat([frames, frames.new_zeros((pad,)
                                                     + frames.shape[1:])])
    outs = []
    for i, dev in enumerate(mesh.devices):
        out = detect_batch(frames[i * per:(i + 1) * per], params=params,
                           dict_names=dict_names, device=dev)
        keep = min(per, max(n - i * per, 0))
        outs.append({name: {key: v[:keep] for key, v in d.items()}
                     for name, d in out.items()})
    if not gather:
        return outs
    return {name: {key: torch.cat([o[name][key].to(mesh.home)
                                   for o in outs])
                   for key in outs[0][name]}
            for name in dict_names}
