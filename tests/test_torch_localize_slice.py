"""Slice 2 as a whole: the port engine maps rendered frames and localizes
more against the map, against the JAX engine doing the same (CPU)."""

import dataclasses

import numpy as np
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.pipeline.engine import ArSlamEngine as JEngine
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine as TEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)


def _f64(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, dtype="float64"))


def _captures(frames, start, stop):
    return [IngestedCapture(f"f{k}", f"f{k}.png", frames[k])
            for k in range(start, stop)]


def _add_jax(engine, caps):
    for uid, by_dict, size, path in engine.detect_decoded(caps):
        engine.store.add_detections(
            uid, [d for dets in by_dict.values() for d in dets], size, path)


def test_engine_localize_matches_jax_engine(monkeypatch):
    """Slice 2 as a whole: map 3 rendered 640x480 frames, then localize 2
    more, in the port (float64, CPU) and the JAX engine.  The port's fused-
    CCL limit is lowered so that its detector takes the strip-scan (K3)
    branch with the round cap, as 12 MP frames do; the JAX CPU path runs
    its XLA CCL, which has the same round and cap.  Required: the same
    observations, the same localized uids, |delta rmse| <= 0.1 px for the
    map and for the queries (the box-filter bound of
    test_torch_slice.py::test_engine_matches_jax_engine)."""
    from ar_slam_tpu.solve import localize_many as j_localize
    from ar_slam_tpu_torch.detect import ccl
    from ar_slam_tpu_torch.detect import detect as tdet

    frames, truth = room_scene(n_frames=5, width=640, height=480,
                               focal=565.0)
    monkeypatch.setattr(tdet, "FUSED_CCL_PIXEL_LIMIT", 1000)
    strip_calls = []
    strip = ccl.connected_components_strip_batch
    monkeypatch.setattr(ccl, "connected_components_strip_batch",
                        lambda b, it: strip_calls.append(it) or strip(b, it))
    je = JEngine(config=_f64(JConfig), use_tpu_detector=True)
    te = TEngine(config=_f64(TConfig), device="cpu", dtype=torch.float64)
    _add_jax(je, _captures(frames, 0, 3))
    te.add_decoded(_captures(frames, 0, 3))
    ref, got = je.solve(), te.solve()
    assert strip_calls and set(strip_calls) == {24}
    assert abs(got["rmse"] - ref["rmse"]) <= 0.1
    first = te.store.next_capture_index
    _add_jax(je, _captures(frames, first, len(frames)))
    ref_loc = j_localize(je.store, first, je.config, dtype=np.float64)
    got_loc = te.localize_decoded(_captures(frames, first, len(frames)))

    def obs(store):
        return {(store.captures[b.cap_idx].uid, store.arucos[b.tag_idx].id)
                for b in store.blocks}

    assert obs(te.store) == obs(je.store)
    assert got_loc["status"] == ref_loc["status"] == {
        "f3": "localized", "f4": "localized"}
    assert abs(got_loc["rmse"] - ref_loc["rmse"]) <= 0.1
    true_tags = {f"aruco_{n}_{m}" for fr in truth["frames"]
                 for n, m, _, _ in fr}
    assert {a.id for a in te.store.arucos} == true_tags
