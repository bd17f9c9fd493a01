"""The serve slice's engine against the JAX engine on a rendered 5-frame
scene (CPU): incremental mapping over two batches, artifact export of one
saved map, and the annotated debug image.  The pipelined stream, the
``serve`` / ``replay`` commands and the load-images service are in
test_torch_serve_cli.py."""

import dataclasses

import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.pipeline.engine import ArSlamEngine as JEngine
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine as TEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)
BATCHES = ((0, 3), (3, 5))


def _f64(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, dtype="float64"))


def _obs(store):
    return {(store.captures[b.cap_idx].uid, store.arucos[b.tag_idx].id)
            for b in store.blocks}


@pytest.fixture(scope="module")
def engines():
    """Both engines map the frames in batches of 3 + 2, each batch followed
    by solve_incremental.  The port adds each batch with add_decoded; the
    JAX engine detects the five frames in one call (one compile of its
    detector; each frame's detections do not depend on its batch) and adds
    each batch's detections to its store.  Returns (port engine, JAX
    engine, [(port summary, JAX summary, port obs, JAX obs)], frames)."""
    frames, _ = room_scene(n_frames=5, width=640, height=480, focal=565.0)
    caps = [IngestedCapture(f"f{k}", f"f{k}.png", frames[k])
            for k in range(len(frames))]
    te = TEngine(config=_f64(TConfig), device="cpu", dtype=torch.float64)
    je = JEngine(config=_f64(JConfig), use_tpu_detector=True)
    j_dets = je.detect_decoded(caps)
    calls = []
    for a, b in BATCHES:
        te.add_decoded(caps[a:b])
        got = te.solve_incremental()
        for uid, by_dict, size, path in j_dets[a:b]:
            je.store.add_detections(
                uid, [d for dets in by_dict.values() for d in dets], size,
                path)
        ref = je.solve_incremental()
        calls.append((got, ref, _obs(te.store), _obs(je.store)))
    return te, je, calls, frames


@pytest.mark.parametrize("call", [0, 1])
def test_incremental_engine_matches_jax_engine(engines, call):
    """The same (capture, tag) observations after each batch, the same
    waves and unsolved counts, and |delta rmse| <= 0.1 px: the box-filter
    bound of test_torch_slice.py::test_engine_matches_jax_engine (the JAX
    CPU path's float32 integral images move single refined corners)."""
    got, ref, t_obs, j_obs = engines[2][call]
    assert t_obs == j_obs
    assert got["waves"] == ref["waves"] == BATCHES[call][1] - BATCHES[call][0]
    assert got["unsolved"] == ref["unsolved"] == 0
    assert abs(got["rmse"] - ref["rmse"]) <= 0.1
    assert got["rmse"] < 1.0


def _close(a, b, tol):
    """Recursive equality of artifact records, floats within ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, str):
        assert a == b
    else:
        assert abs(float(a) - float(b)) <= tol, (a, b)


@pytest.fixture(scope="module")
def saved_map(engines, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "map.yaml")
    engines[0].save_map(path)
    return path


def test_export_artifacts_matches_jax(saved_map):
    """Transforms, camera info and markers of one saved map, loaded by
    both engines, equal to 1e-9."""
    te = TEngine(device="cpu")
    te.load_map(saved_map)
    je = JEngine(use_tpu_detector=False)
    je.load_map(saved_map)
    got, ref = te.export_artifacts(), je.export_artifacts()
    assert len(got["transforms"]) == len(te.store.arucos) + 5
    assert len(got["markers"]) == 1 + len(te.store.arucos)
    _close(got, ref, 1e-9)


def test_annotate_capture_matches_jax(engines, saved_map, tmp_path,
                                      monkeypatch):
    """Both packages' annotate_capture on one capture of the saved map:
    the same image size and the same polygons drawn, projections within
    1e-6 px."""
    from PIL import Image

    from ar_slam_tpu.graph import MapStore as JStore
    from ar_slam_tpu.graph import load_yaml as j_load
    from ar_slam_tpu.viz import annotate as j_annotate
    from ar_slam_tpu_torch.graph.store import MapStore as TStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml as t_load
    from ar_slam_tpu_torch.viz import annotate as t_annotate

    frames = engines[3]
    drawn = {"jax": [], "port": []}
    for key, mod in (("jax", j_annotate), ("port", t_annotate)):
        monkeypatch.setattr(
            mod, "_draw_poly", lambda draw, pts, color, width=2, key=key:
            drawn[key].append((color, np.asarray(pts, dtype=float))))
    ts, js = TStore(), JStore()
    t_load(ts, saved_map)
    j_load(js, saved_map)
    t_out = t_annotate.annotate_capture(ts, 1, frames[1],
                                        str(tmp_path / "t.png"),
                                        show_all_tags=True)
    j_out = j_annotate.annotate_capture(js, 1, frames[1],
                                        str(tmp_path / "j.png"),
                                        show_all_tags=True)
    assert Image.open(t_out).size == Image.open(j_out).size == (640, 480)
    assert [c for c, _ in drawn["port"]] == [c for c, _ in drawn["jax"]]
    assert len(drawn["port"]) >= 2 * len(ts.captures[1].blocks)
    for (_, a), (_, b) in zip(drawn["port"], drawn["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
