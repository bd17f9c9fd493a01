"""Port parity: the batch BFS solve (solve/batch.py) against the JAX
package on the cv2 detections of the four demo photos, float64 on the
CPU."""

import os

import numpy as np
import torch
import yaml

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.graph.store import MapStore as JStore
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.solve.batch import solve as t_solve

torch.set_num_threads(1)
SIZE = 0.0635
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _demo_store(n=4):
    with open(os.path.join(FIXTURES, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    store = JStore()
    for cap in data["captures"][:n]:
        dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
                for name in ("4X4_50", "5X5_100")
                for d in cap["detections"].get(name, [])]
        store.add_detections(cap["uid"], dets, (cap["width"],
                                                cap["height"]), cap["img_fn"])
    return store


def test_batch_solve_demo_fixture_matches():
    """The BFS batch solve (seeding, warmup, LM) on the cv2 detections of
    the four demo photos: rmse equal to the JAX solve at float64."""
    js = _demo_store()
    ts = store_from_jax(js)
    ref = j_solve(js, JConfig(), dtype=np.float64)
    got = t_solve(ts, TConfig(), dtype=torch.float64, device="cpu")
    assert got["waves"] == ref["waves"] == 4
    assert abs(got["rmse"] - ref["rmse"]) <= 1e-6 * ref["rmse"]
    assert got["rmse"] < 1.0
    np.testing.assert_allclose(ts.camera.params, js.camera.params,
                               rtol=1e-6)


def test_apply_wave_seeds_matches_jax():
    """One wave's seeds (a capture from its anchors, then its new tags
    through it) equal the JAX package's ``apply_wave_seeds`` within 1e-10,
    and are ``apply_wave_seeds_multi`` of that one wave."""
    import jax.numpy as jnp

    from ar_slam_tpu.solve.batch import apply_wave_seeds as j_seeds
    from ar_slam_tpu_torch.solve.batch import (apply_wave_seeds,
                                               apply_wave_seeds_multi)
    from torch_cases import synthetic_arrays

    a = synthetic_arrays(seed=5, n_tags=20, n_caps=10, perturb=0.05)
    cap = 2
    rows = np.flatnonzero((a.cap_idx == cap) & a.block_mask)
    anchors, new = rows[:len(rows) // 2], rows[len(rows) // 2:]
    tags = a.tag_idx[new]
    wave = (cap, int(anchors[0]), new.tolist(), tags.tolist(),
            anchors.tolist())
    t = {k: torch.as_tensor(getattr(a, k)) for k in (
        "camera", "cap_poses", "tag_poses", "tag_idx", "corners")}
    got = apply_wave_seeds(t["camera"], t["cap_poses"], t["tag_poses"],
                           t["tag_idx"].long(), t["corners"], wave, SIZE,
                           "hybrid")
    multi = apply_wave_seeds_multi(t["camera"], t["cap_poses"],
                                   t["tag_poses"], t["tag_idx"].long(),
                                   t["corners"], [wave], SIZE, "hybrid")
    init = np.full(a.tag_poses.shape[0], -1, np.int32)
    init[tags] = new
    ref = j_seeds(jnp.asarray(a.camera), jnp.asarray(a.cap_poses),
                  jnp.asarray(a.tag_poses), jnp.asarray(a.cap_idx),
                  jnp.asarray(a.tag_idx), jnp.asarray(a.corners), cap,
                  int(anchors[0]), jnp.asarray(init),
                  jnp.asarray(anchors.astype(np.int32)),
                  jnp.ones(len(anchors), bool), SIZE, "hybrid")
    for g, m, r, before in zip(got, multi, ref, (a.cap_poses, a.tag_poses)):
        assert torch.equal(g, m)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)
        assert not np.array_equal(g.numpy(), before)
