"""Port parity: pose-only localization (solve/localize.py) against the JAX
package's ``localize_many``, float64 on the CPU.  Each case builds and
solves the map once in the JAX package and hands a copy of the store to
the port, so both localize against the same frozen map."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.graph import MapStore as JStore
from ar_slam_tpu.solve import localize_many as j_localize
from ar_slam_tpu.solve import solve_batch
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.solve.localize import localize_many as t_localize
from tests.test_localize import FIXTURES, add_fixture_capture

torch.set_num_threads(1)


def _configs(unknown_tags=False):
    jc, tc = JConfig(), TConfig()
    if unknown_tags:
        jc = dataclasses.replace(jc, solver=dataclasses.replace(
            jc.solver, localize_unknown_tags=True))
        tc = dataclasses.replace(tc, solver=dataclasses.replace(
            tc.solver, localize_unknown_tags=True))
    return jc, tc


def _both(js, first, unknown_tags=False):
    """Localize a copy in the port, then the JAX store itself; returns
    (port store, port result, JAX result)."""
    jc, tc = _configs(unknown_tags)
    ts = store_from_jax(js)
    got = t_localize(ts, first, tc, dtype=torch.float64, device="cpu")
    ref = j_localize(js, first, jc, dtype=np.float64)
    return ts, got, ref


def _assert_same(js, ts, first, got, ref):
    assert got["status"] == ref["status"]
    assert got["localized"] == ref["localized"]
    if not ref["localized"]:
        return
    assert got["iterations"] == ref["iterations"]
    assert abs(got["rmse"] - ref["rmse"]) <= 1e-9 * max(ref["rmse"], 1e-3)
    for jcap, tcap in zip(js.captures[first:], ts.captures[first:]):
        np.testing.assert_allclose(tcap.inv_pose, jcap.inv_pose, rtol=0,
                                   atol=1e-8)


@pytest.fixture(scope="module")
def solved_demo():
    """tests/test_lm.py:load_demo_store's img1-3 map, solved once; the
    Python graph backend, so that each test can take a deep copy."""
    with open(os.path.join(FIXTURES, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    js = JStore(native=False)
    for cap in data["captures"][:3]:
        dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
                for d in cap["detections"]["4X4_50"]]
        js.add_detections(cap["uid"], dets, (cap["width"], cap["height"]),
                          cap["img_fn"])
    solve_batch(js, JConfig(), dtype=np.float64)
    return js


@pytest.fixture
def demo_map(solved_demo):
    """A fresh copy of the solved img1-3 map and its first query index."""
    js = copy.deepcopy(solved_demo)
    return js, js.next_capture_index


def test_localize_demo_query_matches_jax(demo_map):
    """The img4 query (cap_3) against the img1-3 map: the same pose within
    1e-8, the same rmse (1.6239 px, BASELINE.md) and iteration count."""
    js, first = demo_map
    add_fixture_capture(js, "cap_3")
    cam, tags = js.camera.params.copy(), [t.pose.copy() for t in js.arucos]
    ts, got, ref = _both(js, first)
    _assert_same(js, ts, first, got, ref)
    assert abs(got["rmse"] - 1.6239) < 1e-4
    np.testing.assert_array_equal(ts.camera.params, cam)  # pose-only
    for tag, before in zip(ts.arucos, tags):
        np.testing.assert_array_equal(tag.pose, before)


def test_localize_synthetic_batch_matches_jax():
    """Four queries in one batched solve (tests/test_localize.py's
    synthetic split: map = captures 0-5, queries = the rest)."""
    store, _ = make_synthetic_map(n_tags=12, n_caps=10, seed=8)
    js = JStore(initial_focal=3000.0)
    js.camera.size = store.camera.size
    queries = []
    for cap in store.captures:
        dets = [(store.arucos[store.blocks[bh].tag_idx].id,
                 store.blocks[bh].corners) for bh in cap.blocks]
        if int(cap.uid.split("_")[1]) < 6:
            js.add_detections(cap.uid, dets, store.camera.size)
        else:
            queries.append((cap.uid, dets))
    solve_batch(js, JConfig(), dtype=np.float64)
    first = js.next_capture_index
    for uid, dets in queries:
        js.add_detections(uid, dets, js.camera.size)
    ts, got, ref = _both(js, first)
    _assert_same(js, ts, first, got, ref)
    assert got["localized"] == len(queries) == 4
    assert got["rmse"] < 0.5


def test_localize_disconnected_capture_matches_jax(demo_map):
    js, first = demo_map
    js.add_detections(
        "stranger", [("aruco_4X4_50_49", np.array(
            [[-10, -10], [10, -10], [10, 10], [-10, 10]], float))],
        js.camera.size)
    add_fixture_capture(js, "cap_3")
    ts, got, ref = _both(js, first)
    _assert_same(js, ts, first, got, ref)
    assert got["status"] == {"stranger": "disconnected", "cap_3": "localized"}


@pytest.mark.parametrize("unknown_tags", [False, True])
def test_localize_unknown_tags_switch_matches_jax(demo_map, unknown_tags):
    """An extra observation of a tag the map has never seen: ignored by
    default, joined at its zero pose under the parity switch (the
    reference's localizeOne); both packages agree either way."""
    js, first = demo_map
    cap_idx = add_fixture_capture(js, "cap_3")
    tag = js.get_or_add_aruco("aruco_4X4_50_49")
    js.add_block(np.array([[-60, -60], [-20, -60], [-20, -20], [-60, -20]],
                          float), cap_idx, tag.index)
    ts, got, ref = _both(js, first, unknown_tags)
    _assert_same(js, ts, first, got, ref)
    if unknown_tags:
        assert got["cost"] > 10.0
    else:
        assert got["rmse"] < 2.0


def test_padded_width_changes_no_result():
    """Masked blocks beyond the widest query leave every pose, cost and
    iteration count as the exact width gives them."""
    from ar_slam_tpu_torch.solve.localize import localize_batch
    from ar_slam_tpu_torch.solve.lm import LMConfig
    from tests.torch_cases import localize_queries

    cam, tags, q_tag, q_crn, q_mask, q_seed = localize_queries()
    extra = 16 - q_tag.shape[1]
    pad = [np.pad(q_tag, ((0, 0), (0, extra))),
           np.pad(q_crn, ((0, 0), (0, extra), (0, 0), (0, 0))),
           np.pad(q_mask, ((0, 0), (0, extra)))]
    kw = dict(aruco_size=0.0635, config=LMConfig(max_iterations=20))

    def solve(t, c, m):
        return localize_batch(*(torch.as_tensor(x) for x in (
            cam, tags, t, c, m, q_seed)), **kw)

    exact, padded = solve(q_tag, q_crn, q_mask), solve(*pad)
    for a, b in zip(exact, padded):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-12)
