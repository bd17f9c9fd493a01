"""A room mapped from its phone photos, one map after another.

Set-up renders the configuration's map photos.  Each operation is what
``arslam-torch map`` does with photos in memory: a fresh ``ArSlamEngine``,
``add_decoded`` of the photos (one detection batch on the card), then
``solve()`` (focal self-calibration, the BFS waves with their seeds and the
LM), ending with the map's poses on the host.

The comparison: each photo's detections against the rendered truth (every
required tag found, no foreign id, the corners) and against the plain
detector on the same photo (the corners), and the map against the plain
reference's float64 bundle adjustment of the same detections from the
scene's poses: the reprojection cost at the map's poses above the
reference's optimum, and the map's rmse against its own poses.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import rooms
from benchmark.reference import detections as D
from benchmark.reference import geometry as G
from benchmark.reference import lm as L
from benchmark.rooms import Truth, engine_config, scene_of
from benchmark.scenes import room as R


class Cell:
    def __init__(self, ctx):
        from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture

        cfg, mix = ctx.cfg, ctx.mix
        self.ctx = ctx
        scene = scene_of(cfg)
        self.photos = list(cfg["map_photos"])
        self.truth = Truth(scene, self.photos)
        self.caps = [IngestedCapture(f"p{k:02d}", f"p{k:02d}.png",
                                     R.render(scene, k)) for k in self.photos]
        self.config = engine_config(cfg)
        self.detect_shapes = []
        for _ in range(int(mix["warm_calls"])):
            self.after(self.op())
        self.detect_shapes.clear()

    def op(self):
        from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine

        spans = self.ctx.spans
        engine = ArSlamEngine(self.config, device=self.ctx.device)
        if spans is not None:
            engine._run_detector = spans.wrap("detect", engine._run_detector)
        if self.ctx.fault in rooms.DETECTION_FAULTS:
            engine._run_detector = rooms.altered_detections(
                engine._run_detector, self.ctx.fault)
        engine.add_decoded(self.caps)
        solve = engine.solve
        if spans is not None:
            solve = spans.wrap("solve", solve)
        summary = solve()
        return engine.store, summary

    def after(self, res) -> dict:
        store, summary = res
        rec = {"rmse": summary.get("rmse", float("nan")),
               "waves": summary.get("waves", 0),
               "focal": float(store.camera.params[0]),
               "caps": {c.uid: c.inv_pose.copy() for c in store.captures},
               "tags": {t.id: t.pose.copy() for t in store.arucos},
               "blocks": [(store.captures[b.cap_idx].uid,
                           store.arucos[b.tag_idx].id, b.corners.copy())
                          for b in store.blocks]}
        if self.ctx.fault == "answer":  # the map altered where produced
            rec["tags"] = {k: v + 0.002 for k, v in rec["tags"].items()}
        if self.ctx.fault == "unchanged":  # the solve left its start
            rec["tags"] = {k: np.zeros(6) for k in rec["tags"]}
        rec["failed"] = (rec["waves"] != len(self.photos)
                         or not np.isfinite(rec["rmse"]))
        n_pad = 1 << (len(self.photos) - 1).bit_length()
        self.detect_shapes.append((n_pad, self.ctx.cfg["height"],
                                   self.ctx.cfg["width"]))
        return rec

    def counters(self, records) -> dict:
        return {"photos": len(self.photos) * len(records),
                "maps": len(records), "detect_shapes": self.detect_shapes,
                "windows": len(self.ctx.cfg["detect"]["windows"])}

    def end_to_end(self, records, latencies, window_s) -> dict:
        return {"map_s": window_s / len(records)}

    def release(self):
        self.caps = None
        return self.truth


def blocks_of(truth: Truth, rec: dict):
    """The map's blocks whose tag is rendered in the scene: photo index,
    tag id, corners."""
    uid_k = {f"p{k:02d}": k for k in truth.sightings}
    return [(uid_k[u], t, c) for u, t, c in rec["blocks"]
            if t in truth.tag_pose]


def _tensors(blocks, device):
    caps = sorted({k for k, _, _ in blocks})
    tags = sorted({t for _, t, _ in blocks})
    ci = {k: i for i, k in enumerate(caps)}
    ti = {t: i for i, t in enumerate(tags)}
    return (caps, tags,
            torch.tensor([ci[k] for k, _, _ in blocks], device=device),
            torch.tensor([ti[t] for _, t, _ in blocks], device=device),
            torch.as_tensor(np.stack([c for _, _, c in blocks]),
                            dtype=torch.float64, device=device))


def reference_map(truth: Truth, blocks, device, precision: str = "f64"):
    """The plain reference's bundle adjustment of ``blocks`` from the
    scene's poses: (focal, caps {photo: pose}, tags {id: pose}, cost)."""
    caps, tags, cap_idx, tag_idx, obs = _tensors(blocks, device)
    f64 = torch.float64
    c0 = torch.as_tensor(np.stack([truth.scene.inv_poses[k] for k in caps]),
                         dtype=f64, device=device)
    t0 = torch.as_tensor(np.stack([truth.tag_pose[t] for t in tags]),
                         dtype=f64, device=device)
    f, cp, tp, _ = L.bundle_adjust(truth.scene.focal, c0, t0, cap_idx,
                                   tag_idx, obs, truth.scene.aruco_size,
                                   precision)
    cost = G.cost(f, cp, tp, cap_idx, tag_idx, obs, truth.scene.aruco_size)
    return (float(f), dict(zip(caps, cp.double().cpu().numpy())),
            dict(zip(tags, tp.double().cpu().numpy())), cost)


def map_cost(truth: Truth, blocks, focal, caps: dict, tags: dict, device):
    """The float64 cost of ``blocks`` at the given poses."""
    kc, kt, cap_idx, tag_idx, obs = _tensors(blocks, device)
    cp = torch.as_tensor(np.stack([caps[k] for k in kc]),
                         dtype=torch.float64, device=device)
    tp = torch.as_tensor(np.stack([tags[t] for t in kt]),
                         dtype=torch.float64, device=device)
    return G.cost(focal, cp, tp, cap_idx, tag_idx, obs,
                  truth.scene.aruco_size)


def detections_of(rec: dict, photos: list) -> list:
    """[(photo, [(tag id, centered corners)])] of a map's blocks, for every
    photo mapped."""
    by_photo = {k: [] for k in photos}
    for u, t, c in rec["blocks"]:
        by_photo[int(u[1:])].append((t, c))
    return list(by_photo.items())


def map_numbers(truth: Truth, records, device) -> dict:
    """cost_gap: the largest (cost at a map's poses - the reference's
    optimum) / the optimum; rmse_gap_px: of a map's rmse to the one at its
    poses; the focal's gap to the reference's is printed only."""
    distinct = {}
    cost_gap = focal_gap = rmse_gap = 0.0
    for rec in records:
        blocks = blocks_of(truth, rec)
        key = tuple((k, t, c.tobytes()) for k, t, c in blocks)
        if key not in distinct:
            distinct[key] = reference_map(truth, blocks, device)
        f_ref, _, _, c_ref = distinct[key]
        caps = {int(u[1:]): p for u, p in rec["caps"].items()}
        c_map = map_cost(truth, blocks, rec["focal"], caps, rec["tags"],
                         device)
        cost_gap = max(cost_gap, (c_map - c_ref) / c_ref)
        focal_gap = max(focal_gap, abs(rec["focal"] - f_ref) / f_ref)
        every = [(int(u[1:]), t, c) for u, t, c in rec["blocks"]]
        c_all = map_cost(truth, every, rec["focal"], caps, rec["tags"],
                         device)
        rmse_gap = max(rmse_gap, abs(rec["rmse"] - float(np.sqrt(
            2.0 * c_all / (8 * len(every))))))
    print(f"benchmark: focal gap (not compared) {focal_gap}",
          file=sys.stderr)
    return {"cost_gap": cost_gap, "rmse_gap_px": rmse_gap}


def check(ctx, truth: Truth, records, limits: dict) -> dict:
    cfg = ctx.cfg
    records = [r for r in records if r]
    photos = list(cfg["map_photos"])
    plain = rooms.plain_detections(truth, photos, cfg)
    got = rooms.detection_numbers(
        truth, [d for r in records for d in detections_of(r, photos)], plain,
        cfg["min_side_px"])
    got.update(map_numbers(truth, records, ctx.device))
    return {k: (got[k], limits[k]) for k in limits}


def control(ctx, truth: Truth, records, precision: str) -> dict:
    """The numbers of the plain reference put in the program's place, a
    stage at a time: the plain detector with its corner arithmetic in
    bfloat16 held to the plain detector; the bundle adjustment in
    ``precision`` of every rendered tag's corners projected from the
    scene's poses."""
    cfg = ctx.cfg
    photos = list(cfg["map_photos"])
    plain = rooms.plain_detections(truth, photos, cfg)
    low = rooms.plain_detections(truth, photos, cfg, "bf16")
    got = rooms.detection_numbers(
        truth, [(k, [(t, c - truth.center) for t, c in low[k]])
                for k in photos], plain, cfg["min_side_px"])
    dt = G.dtype_of(precision)
    blocks = []
    for k in truth.sightings:
        seen = truth.sightings[k]
        tags = torch.as_tensor(np.stack([truth.tag_pose[D.tag_id(n, m)]
                                         for n, m, *_ in seen]),
                               dtype=dt, device=ctx.device)
        caps = torch.as_tensor(truth.scene.inv_poses[k], dtype=dt,
                               device=ctx.device).expand(len(seen), 6)
        uv = G.project(torch.as_tensor(truth.scene.focal, dtype=dt), caps,
                       tags, truth.scene.aruco_size, precision)
        blocks += [(f"p{k:02d}", D.tag_id(n, m), c) for (n, m, *_), c in
                   zip(seen, uv.double().cpu().numpy())]
    as_map = [(int(u[1:]), t, c) for u, t, c in blocks]
    f, caps, tags, _ = reference_map(truth, as_map, ctx.device, precision)
    # the control's own rmse, in its precision, as the program reports one
    kc, kt, cap_idx, tag_idx, obs = _tensors(as_map, ctx.device)
    c_all = float(L._cost(
        torch.as_tensor(f, dtype=dt, device=ctx.device),
        torch.as_tensor(np.stack([caps[k] for k in kc]), dtype=dt,
                        device=ctx.device),
        torch.as_tensor(np.stack([tags[t] for t in kt]), dtype=dt,
                        device=ctx.device),
        cap_idx, tag_idx, obs.to(dt), truth.scene.aruco_size, precision))
    rec = {"blocks": blocks, "focal": f, "tags": tags,
           "caps": {f"p{k:02d}": p for k, p in caps.items()},
           "rmse": float(np.sqrt(2.0 * c_all / (8 * len(as_map))))}
    got.update(map_numbers(truth, [rec], ctx.device))
    return got
