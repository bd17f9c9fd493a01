"""Port parity: the incremental solve (solve/batch.py:solve_incremental)
against the JAX package's, float64 on the CPU, both fed the same
detections: a map growing over two calls, a capture parked until a bridge
arrives, and a saved map extended after a reload.  The synthetic maps carry
0.3 px of corner noise, so the rmse compared is not zero.  One JAX run per
scenario, shared by its cases (the JAX solves compile per shape)."""

import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.graph import MapStore as JStore
from ar_slam_tpu.graph import load_yaml as j_load
from ar_slam_tpu.graph import save_yaml as j_save
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu.solve.batch import solve_incremental as j_inc
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.graph.store import MapStore as TStore
from ar_slam_tpu_torch.graph.yamlio import load_yaml as t_load
from ar_slam_tpu_torch.solve.batch import solve_incremental as t_inc

torch.set_num_threads(1)
TOL = 1e-6
STRANGER = [("aruco_4X4_50_49", np.array([[-40, -40], [40, -40], [40, 40],
                                          [-40, 40]], float))]


def _dets(store, cap):
    return [(store.arucos[store.blocks[bh].tag_idx].id,
             store.blocks[bh].corners) for bh in cap.blocks]


def _state(store):
    return {"caps": np.stack([c.inv_pose for c in store.captures]),
            "tags": np.stack([t.pose for t in store.arucos]),
            "camera": np.array(store.camera.params, dtype=float),
            "unsolved": {store.captures[i].uid
                         for i in store.unsolved_captures}}


def _run(js, ts, additions):
    """For each list of (uid, detections, size) in ``additions``: add them
    to both stores and run both incremental solves.  Returns one (JAX
    summary, port summary, JAX state, port state) per call."""
    out = []
    for batch in additions:
        for uid, dets, size in batch:
            js.add_detections(uid, dets, size)
            ts.add_detections(uid, dets, size)
        ref = j_inc(js, JConfig(), dtype=np.float64)
        got = t_inc(ts, TConfig(), dtype=torch.float64, device="cpu")
        out.append((ref, got, _state(js), _state(ts)))
    return out


def _check(call):
    ref, got, js, ts = call
    assert got["waves"] == ref["waves"]
    assert got["unsolved"] == ref["unsolved"]
    assert ts["unsolved"] == js["unsolved"]
    if "rmse" in ref:
        assert abs(got["rmse"] - ref["rmse"]) <= TOL * ref["rmse"]
    np.testing.assert_allclose(ts["caps"], js["caps"], rtol=0, atol=TOL)
    np.testing.assert_allclose(ts["tags"], js["tags"], rtol=0, atol=TOL)
    # the focal in pixels, the radial terms at 0
    np.testing.assert_allclose(ts["camera"], js["camera"], rtol=TOL,
                               atol=TOL)


@pytest.fixture(scope="module")
def growth():
    """Captures 0-2, then 3-5 (tests/test_incremental.py:22-42)."""
    src, _ = make_synthetic_map(n_tags=12, n_caps=8, seed=10, noise_px=0.3)
    js, ts = JStore(), TStore()
    js.camera.size = ts.camera.size = src.camera.size
    return _run(js, ts, [
        [(c.uid, _dets(src, c), src.camera.size) for c in src.captures[a:b]]
        for a, b in ((0, 3), (3, 6))])


@pytest.mark.parametrize("call", [0, 1])
def test_growth_matches_jax(growth, call):
    ref, got, _, _ = growth[call]
    assert got["waves"] == 3 and got["unsolved"] == 0
    assert got["rmse"] < 1.0
    _check(growth[call])


@pytest.fixture(scope="module")
def parking():
    """A capture that sees only an unknown tag stays unsolved until a
    bridge capture sees it and a map tag (tests/test_incremental.py:46-71).
    It starts from captures 0-2 of the growth map, whose padded shapes the
    JAX programs compiled for growth's first call cover."""
    src, _ = make_synthetic_map(n_tags=12, n_caps=8, seed=10, noise_px=0.3)
    js, ts = JStore(), TStore()
    js.camera.size = ts.camera.size = src.camera.size
    size = src.camera.size
    return _run(js, ts, [
        [(c.uid, _dets(src, c), size) for c in src.captures[:3]],
        [("stranger", STRANGER, size)],
        [("bridge", _dets(src, src.captures[3]) + STRANGER, size)]])


@pytest.mark.parametrize("call", [0, 1, 2])
def test_parking_matches_jax(parking, call):
    ref, got, _, ts = parking[call]
    assert (got["waves"], got["unsolved"]) == [(3, 0), (0, 1), (2, 0)][call]
    if call == 1:
        assert ts["unsolved"] == {"stranger"}
    _check(parking[call])


def test_reloaded_map_extends_like_jax(tmp_path):
    """A map solved by the batch solve, saved, loaded by both packages,
    extended with two captures and solved incrementally: the solved
    captures re-enter the runner without an LM pass in both."""
    src, _ = make_synthetic_map(n_tags=12, n_caps=8, seed=10, noise_px=0.3)
    first = JStore()
    first.camera.size = src.camera.size
    for c in src.captures[:3]:
        first.add_detections(c.uid, _dets(src, c), src.camera.size)
    j_solve(first, JConfig(), dtype=np.float64)
    path = str(tmp_path / "map.yaml")
    j_save(first, path)
    js, ts = JStore(), TStore()
    j_load(js, path)
    t_load(ts, path)
    assert not js.unsolved_captures and not ts.unsolved_captures
    [call] = _run(js, ts, [[(c.uid, _dets(src, c), src.camera.size)
                            for c in src.captures[3:5]]])
    assert call[1]["waves"] == 2 and call[1]["unsolved"] == 0
    _check(call)


def test_empty_store():
    assert t_inc(store_from_jax(JStore()), TConfig(),
                 device="cpu") == j_inc(JStore(), JConfig()) == {"waves": 0}
