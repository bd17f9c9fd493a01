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


STRANGER = ("stranger", [("aruco_4X4_50_49", np.array(
    [[-10, -10], [10, -10], [10, 10], [-10, 10]], float))])


@pytest.mark.parametrize("n_queries,stranger_at",
                         [(4, None), (3, 1), (4, 2)])
def test_localize_synthetic_batch_matches_jax(n_queries, stranger_at):
    """Several queries in one batched solve (tests/test_localize.py's
    synthetic split: map = captures 0-5, queries = the rest), with a
    disconnected capture among them where ``stranger_at`` says: its
    neighbours keep their rows, and the padded query axis (3 real
    queries padded to 4) changes nothing."""
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
    queries = queries[:n_queries]
    if stranger_at is not None:
        queries.insert(stranger_at, STRANGER)
    for uid, dets in queries:
        js.add_detections(uid, dets, js.camera.size)
    ts, got, ref = _both(js, first)
    _assert_same(js, ts, first, got, ref)
    assert got["localized"] == n_queries
    assert got["status"].get("stranger") == (
        None if stranger_at is None else "disconnected")
    assert got["rmse"] < 0.5


def test_localize_disconnected_capture_matches_jax(demo_map):
    js, first = demo_map
    js.add_detections(*STRANGER, js.camera.size)
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


@pytest.mark.parametrize("axis,n", [("width", None), ("queries", 3),
                                    ("queries", 5), ("tags", None)])
def test_padded_width_changes_no_result(axis, n):
    """Padding to ``localize_many``'s buckets changes no real query: masked
    blocks beyond the widest query, queries without blocks beyond the last
    (3 -> 4, 5 -> 8) and tag rows beyond the map's leave every pose, cost
    and iteration count as the exact shapes give them."""
    from ar_slam_tpu_torch.graph.arrays import bucket_size
    from ar_slam_tpu_torch.solve.graphs import localize_graphed
    from ar_slam_tpu_torch.solve.lm import LMConfig
    from tests.torch_cases import localize_queries, pad_queries

    case = localize_queries()
    if n is not None:
        case = case[:2] + tuple(a[:n] for a in case[2:])
    q, k = case[2].shape
    padded = pad_queries(case, **{
        "width": dict(k=bucket_size(k, floor=4)),
        "queries": dict(q=bucket_size(q, floor=4)),
        "tags": dict(t=bucket_size(len(case[1])))}[axis])
    assert padded[2].shape != (q, k) or len(padded[1]) > len(case[1])
    kw = dict(aruco_size=0.0635, config=LMConfig(max_iterations=20),
              graphed=False)

    def solve(arrays):
        return localize_graphed(*(torch.as_tensor(x) for x in arrays), **kw)

    for a, b in zip(solve(case), solve(padded)):
        np.testing.assert_allclose(b[:q].numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-12)


def _width_store(widths):
    """The 24-tag synthetic scene's 8 captures as a map at the true tag
    poses, then one query per width: the first ``w`` sightings of a map
    capture that sees at least ``w`` tags, all of them map-known."""
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map as tmap

    store, truth = tmap(n_tags=24, n_caps=8, seed=8)
    for tag in store.arucos:
        tag.pose[:] = truth["tag_poses"][int(tag.id.split("_")[-1])]
    first = store.next_capture_index
    for i, w in enumerate(widths):
        src = next(c for c in store.captures[:first] if len(c.blocks) >= w)
        store.add_detections(f"query_{i}", [
            (store.arucos[store.blocks[bh].tag_idx].id,
             store.blocks[bh].corners) for bh in src.blocks[:w]],
            store.camera.size)
    return store, first


@pytest.mark.parametrize("widths,k,q", [
    ((12,), 16, 4), ((14,), 16, 4), ((15,), 16, 4), ((18,), 32, 4),
    ((15, 18, 12), 32, 4), ((12, 14, 15, 18, 15), 32, 8)])
def test_localize_width_is_bucketed(monkeypatch, widths, k, q):
    """``localize_many`` hands the solve its shapes bucketed as the JAX
    package's: the block axis to ``bucket_size(k, floor=4)``, the query
    axis to ``bucket_size(q, floor=4)``, a map of 24 tags to 32 rows; the
    summary and the poses cover the real queries alone."""
    from ar_slam_tpu_torch.solve import graphs

    seen, real = [], graphs.localize_graphed

    def spy(camera, tag_poses, q_tag_idx, *args, **kw):
        seen.append((tuple(q_tag_idx.shape), tag_poses.shape[0]))
        return real(camera, tag_poses, q_tag_idx, *args, **kw)

    monkeypatch.setattr(graphs, "localize_graphed", spy)
    store, first = _width_store(widths)
    got = t_localize(store, first, TConfig(), dtype=torch.float64,
                     device="cpu")
    assert seen == [((q, k), 32)]
    assert got["localized"] == len(got["iterations"]) == len(widths)
    assert got["rmse"] < 0.5
    for cap in store.captures[first:]:
        assert np.isfinite(cap.inv_pose).all()


def test_cache_keeps_localize_programs_per_width():
    """The card keeps a localize program per signature: alternating two
    widths' signatures adds no program after the first of each, and one
    past ``KEEP["localize"]`` drops the least recently used."""
    import weakref

    from ar_slam_tpu_torch import programs

    cache, made = programs.GraphCache(), []
    bound = programs.KEEP["localize"]

    def make():
        made.append(programs.Program({}, True, label="stand-in"))
        return made[-1]

    def sig(k):  # localize_graphed's key at width k
        return (torch.float32, (4, k), 32, "config", 0.0635, "hybrid")

    first = cache.get("localize", "cuda:0", sig(16), make)
    second = weakref.ref(cache.get("localize", "cuda:0", sig(32), make))
    for _ in range(3):
        assert cache.get("localize", "cuda:0", sig(16), make) is first
        assert cache.get("localize", "cuda:0", sig(32), make) is second()
    assert len(made) == 2
    for k in range(2, bound):
        cache.get("localize", "cuda:0", sig(16 * 2 ** k), make)
    assert cache.get("localize", "cuda:0", sig(16), make) is first
    made.clear()
    cache.get("localize", "cuda:0", sig(16 * 2 ** bound), make)
    assert len(made) == 1 and second() is None  # the least recent
    held = [p.signature[1][1] for p in cache._programs.values()]
    assert held == [16 * 2 ** k for k in range(2, bound)] + [
        16, 16 * 2 ** bound]


def test_localize_counts_its_longest_query():
    """Traced, a call counts ``localize.iterations``: the largest iteration
    count it returns over its queries (the replays a host-stepped loop
    runs); two calls add up, and untraced nothing is counted."""
    from ar_slam_tpu_torch.utils.metrics import TRACE

    was = TRACE.enabled
    got = []
    try:
        for traced in (True, True, False):
            TRACE.enabled = traced
            store, first = _width_store((12, 14, 15, 18))
            rng = np.random.default_rng(5)
            for tag in store.arucos:  # a map a little off: some iterations
                tag.pose += rng.normal(scale=2e-3, size=6)
            got.append(t_localize(store, first, TConfig(),
                                  dtype=torch.float64, device="cpu"))
            if traced:
                counts = TRACE.summary()["counts"]
            else:
                assert TRACE.summary()["counts"] == counts
    finally:
        TRACE.enabled = was
        TRACE.reset()
    longest = max(got[0]["iterations"].values())
    assert len(set(got[0]["iterations"].values())) > 1  # it is the largest
    assert got[1]["iterations"] == got[0]["iterations"]
    assert counts["localize.iterations"] == 2 * longest


@pytest.mark.parametrize("fault,error,match", [
    ("cpu", ValueError, "must be a CUDA tensor"),
    ("strided", ValueError, "pose must be contiguous"),
    ("dtype", TypeError, "lam must be torch.float64"),
    ("shape", ValueError, r"q_corners must be \(7, 12, 4, 2\)")])
def test_k5_wrapper_refuses_before_loading(monkeypatch, fault, error, match):
    """K5's wrapper (``localize_lm``) checks the type, layout, shape and
    device of every tensor before it loads the kernels' library: a CPU
    state, a strided pose, a float32 damping in a float64 state and a
    corner table of another width are refused."""
    from ar_slam_tpu_torch import cuda
    from ar_slam_tpu_torch.solve.localize import localize_init, localize_lm
    from ar_slam_tpu_torch.solve.lm import LMConfig
    from tests.torch_cases import localize_queries

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(cuda, "library", no_library)
    case = [torch.as_tensor(x) for x in localize_queries()]
    kw = dict(aruco_size=0.0635, config=LMConfig())
    s = localize_init(*case, **kw)
    corners = case[3]
    if fault == "strided":
        s["pose"] = torch.zeros((len(s["pose"]), 12),
                                dtype=torch.float64)[:, ::2]
    elif fault == "dtype":
        s["lam"] = s["lam"].float()
    elif fault == "shape":
        corners = corners[:, :-1].contiguous()
    assert corners.shape[:2] != s["maskf"].shape or fault != "shape"
    with pytest.raises(error, match=match):
        localize_lm(case[0], corners, s, **kw)


def test_iterations_reader(monkeypatch):
    """``localize_iterations_per_call`` reads ``localize.iterations`` over
    the stretch's operations, and None from an empty tracer or a program
    without the counter."""
    from types import SimpleNamespace

    from benchmark import harness, program_trace

    def view(ops):
        return SimpleNamespace(trace=SimpleNamespace(
            spans=lambda name: [(0.0, 1.0)] * ops if name == "op" else []),
            spans={}, counters={})

    read = harness.reader("localize_iterations_per_call.localize").read
    assert program_trace.summary() is None
    assert read(view(2)) is None
    monkeypatch.setattr(program_trace, "summary", lambda: {
        "spans": {}, "counts": {"host_wait.localize.active": 44}})
    assert read(view(2)) is None
    monkeypatch.setattr(program_trace, "summary", lambda: {
        "spans": {}, "counts": {"localize.iterations": 42}})
    assert read(view(2)) == 21
    assert read(view(0)) is None
