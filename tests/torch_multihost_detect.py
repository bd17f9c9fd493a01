"""One process of the two-process detection test
(tests/test_torch_mesh_repairs.py): joins a gloo process group, detects
its share of the batch in FRAMES (.npy) over an image mesh of one CPU
shard a process, gathers the whole batch's detections and saves them.

    python tests/torch_multihost_detect.py PORT RANK WORLD FRAMES OUT
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from ar_slam_tpu_torch.detect.detect import DetectParams
from ar_slam_tpu_torch.parallel.detect import (detect_batch_sharded,
                                               image_mesh)

port, rank, world, frames_path, out_path = sys.argv[1:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=int(world), rank=int(rank))
try:
    mesh = image_mesh(int(world), device="cpu")
    frames = np.load(frames_path)
    params = DetectParams(win=3, win_sizes=(3, 13, 23), max_candidates=64)
    got = detect_batch_sharded(frames, mesh=mesh, params=params)
    local = detect_batch_sharded(frames, mesh=mesh, params=params,
                                 gather=False)
    np.savez(out_path, n_shards=mesh.n_shards, n_local=mesh.n_local,
             local_images=[o["4X4_50"]["ids"].shape[0] for o in local],
             **{f"{name}.{key}": v.numpy() for name, d in got.items()
                for key, v in d.items()})
finally:
    dist.destroy_process_group()
