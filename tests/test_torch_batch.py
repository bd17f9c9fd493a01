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
