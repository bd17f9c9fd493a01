"""Port parity: data-parallel detection (parallel/detect.py) on the plain
kernels, CPU: four rendered 480x640 frames over three shards (the count
does not divide the batch, so the last shard is padding), against the
port's unsharded detect_batch and the JAX package's detect_batch_sharded
over an image mesh of three virtual CPU devices."""

import jax.numpy as jnp
import numpy as np
import torch

from ar_slam_tpu.detect import tpu_detect as jdet
from ar_slam_tpu.parallel.detect import detect_batch_sharded as j_sharded
from ar_slam_tpu.parallel.detect import image_mesh as j_image_mesh
from ar_slam_tpu_torch.detect import detect as tdet
from ar_slam_tpu_torch.parallel.detect import (detect_batch_sharded,
                                               image_mesh)
from test_torch_detect import _frames

torch.set_num_threads(1)
KW = dict(win=3, win_sizes=(3, 13, 23), max_candidates=64)
NAMES = ("4X4_50", "5X5_100")


def test_sharded_detection_matches_unsharded_and_jax():
    """Every output of the sharded detector equals the unsharded one's
    exactly; the per-shard outputs, concatenated, too; against JAX's
    sharded detector, ids equal exactly and corners within 0.25 px (the
    bound of test_torch_detect.py's detect_batch parity, for the same
    reason)."""
    frames, truth = _frames(n=4)
    mesh = image_mesh(devices=["cpu"] * 3)
    params = tdet.DetectParams(**KW)
    got = detect_batch_sharded(frames, mesh=mesh, params=params,
                               dict_names=NAMES)
    per_shard = detect_batch_sharded(frames, mesh=mesh, params=params,
                                     dict_names=NAMES, gather=False)
    plain = tdet.detect_batch(frames, params=params, dict_names=NAMES,
                              device="cpu")
    ref = j_sharded(jnp.asarray(frames), mesh=j_image_mesh(3),
                    params=jdet.DetectParams(**KW), dict_names=NAMES)
    assert [o[NAMES[0]]["ids"].shape[0] for o in per_shard] == [2, 2, 0]
    for name in NAMES:
        for key in ("ids", "corners", "valid"):
            assert torch.equal(got[name][key], plain[name][key])
            assert torch.equal(
                torch.cat([o[name][key] for o in per_shard]),
                plain[name][key])
        for i in range(len(frames)):
            rv = np.asarray(ref[name]["valid"][i])
            gv = got[name]["valid"][i].numpy()
            r_ids = np.asarray(ref[name]["ids"][i])[rv]
            g_ids = got[name]["ids"][i].numpy()[gv]
            assert sorted(g_ids) == sorted(r_ids)
            assert sorted(g_ids) == sorted(m for d, m in truth[i]
                                           if d == name)
            r_c = dict(zip(r_ids, np.asarray(ref[name]["corners"][i])[rv]))
            g_c = dict(zip(g_ids, got[name]["corners"][i].numpy()[gv]))
            for mid in r_c:
                assert np.abs(g_c[mid] - r_c[mid]).max() <= 0.25
