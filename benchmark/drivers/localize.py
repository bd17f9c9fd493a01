"""Phone photos placed against a saved room map, by one closed-loop client.

Set-up renders the configuration's query photos and writes the map a user
would have saved earlier: the map photos' captures, their tag sightings and
every pose as the scene has them (``load_map``'s calls on the map store).
Each operation is ``ArSlamEngine.localize_decoded`` of ``queries_per_call``
query photos: the calls cycle through every such set of the query photos, in
an order fixed by the mix's ``order_seed``, from a place in the cycle that
the seed picks (so every seed sends the same sets in the same sequence):
detection on the card, then the batched
pose-only LM against the frozen map, timed from the call to its poses on the
host.  ``localize_decoded`` appends its queries to the map store, so the
store is put back between calls, outside the timing.

The comparison: each query's detections against the rendered truth (every
required tag found, no foreign id, the corners) and against the plain
detector on the same photo (the corners), and its pose and the call's rmse against the plain
reference's float64 pose-only LM over the same detections, the map's tags
and focal.
"""

from __future__ import annotations

import sys
from itertools import combinations

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
        from ar_slam_tpu_torch import programs
        from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
        from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
        from ar_slam_tpu_torch.solve import localize as loc_mod

        cfg, mix = ctx.cfg, ctx.mix
        self.cfg, self.mix, self.fault = cfg, mix, ctx.fault
        scene = scene_of(cfg)
        self.queries = list(cfg["query_photos"])
        self.truth = Truth(scene, list(cfg["map_photos"]) + self.queries)
        # the saved map: the map photos' sightings at their rendered corners
        self.map_tags = sorted(_map_tags(cfg, self.truth))
        self.map_blocks = [(f"map{k:02d}", D.tag_id(n, m),
                            crn - self.truth.center)
                           for k in cfg["map_photos"]
                           for n, m, crn, *_ in self.truth.sightings[k]]
        self.caps = {k: IngestedCapture(f"q{k:02d}", f"q{k:02d}.png",
                                        R.render(scene, k))
                     for k in self.queries}
        self.engine = ArSlamEngine(engine_config(cfg), device=ctx.device)
        self.engine.store = self.fresh_store()
        self.loc_mod, self.localize_many = loc_mod, loc_mod.localize_many
        if ctx.spans is not None:
            self.engine._run_detector = ctx.spans.wrap(
                "detect", self.engine._run_detector)
            loc_mod.localize_many = ctx.spans.wrap("localize",
                                                   loc_mod.localize_many)
        if ctx.fault:
            _plant(ctx.fault, self.engine, loc_mod)
        self.programs = programs
        # one cycle through every set, in an order fixed by the mix; the
        # seed picks where a run starts in it, so every seed sends the same
        # sequence of sets and the same changes of width between calls
        sets = list(combinations(self.queries, int(mix["queries_per_call"])))
        order = np.random.default_rng(int(mix["order_seed"])).permutation(
            len(sets))
        self.sets = [list(sets[i]) for i in order]
        self.first = R.seed_word(ctx.seed) % len(self.sets)
        self.calls = 0
        self.detect_shapes = []
        for _ in range(int(mix["warm_calls"])):
            self.after(self.op())
        self.detect_shapes.clear()
        self.calls = 0

    def fresh_store(self):
        """The map store as ``load_map`` leaves it for the saved map."""
        from ar_slam_tpu_torch.graph.store import MapStore

        cfg = self.cfg
        store = MapStore(initial_focal=cfg["focal"])
        for k in cfg["map_photos"]:
            cap = store.add_capture(f"map{k:02d}", "")
            cap.inv_pose = self.truth.scene.inv_poses[k].copy()
        for tid in self.map_tags:
            store.add_aruco(tid).pose = self.truth.tag_pose[tid].copy()
        store.bulk_add_blocks(
            np.stack([c for _, _, c in self.map_blocks]),
            np.array([store.capture_map[u] for u, _, _ in self.map_blocks],
                     np.int32),
            np.array([store.aruco_map[t] for _, t, _ in self.map_blocks],
                     np.int32))
        store.camera.size = (cfg["width"], cfg["height"])
        store.camera.params[0] = cfg["focal"]
        store.camera.focal_calibrated = True
        return store

    def op(self):
        ks = self.sets[(self.first + self.calls) % len(self.sets)]
        self.calls += 1
        first = self.engine.store.next_capture_index
        captures = self.programs.CACHE.captures
        out = self.engine.localize_decoded([self.caps[k] for k in ks])
        return ks, first, out, self.programs.CACHE.captures - captures

    def after(self, res) -> dict:
        ks, first, out, captures = res
        store = self.engine.store
        queries = store.captures[first:]
        rec = {"photos": ks, "rmse": out.get("rmse", float("nan")),
               "poses": [c.inv_pose.copy() for c in queries],
               "dets": [[(store.arucos[store.blocks[b].tag_idx].id,
                          store.blocks[b].corners.copy()) for b in c.blocks]
                        for c in queries],
               "iterations": sum(out.get("iterations", {}).values()),
               "captures": captures}
        rec["failed"] = (len(queries) != len(ks) or set(
            out.get("status", {}).values()) != {"localized"})
        n_pad = 1 << (len(ks) - 1).bit_length()  # the engine's batch
        self.detect_shapes.append((n_pad, self.cfg["height"],
                                   self.cfg["width"]))
        self.engine.store = self.fresh_store()
        return rec

    def counters(self, records) -> dict:
        return {"photos": sum(len(r["photos"]) for r in records if r),
                "calls": len(records),
                "captures": sum(r["captures"] for r in records if r),
                "detect_shapes": self.detect_shapes,
                "windows": len(self.cfg["detect"]["windows"])}

    def end_to_end(self, records, latencies, window_s) -> dict:
        photos = sum(len(r["photos"]) for r in records if r)
        lat = np.asarray(latencies) * 1e3
        cap = np.array([bool(r and r["captures"]) for r in records])
        print(f"benchmark: {len(lat)} calls, {int(cap.sum())} with a capture;"
              f" ms p50 {np.median(lat)}, p95 {np.quantile(lat, 0.95)}, "
              f"mean with a capture {lat[cap].mean() if cap.any() else 0}, "
              f"without {lat[~cap].mean() if (~cap).any() else 0}",
              file=sys.stderr)
        return {"localize_photos_per_s": photos / window_s,
                "localize_p95_ms": 1e3 * float(np.quantile(
                    np.asarray(latencies), 0.95, method="higher"))}

    def release(self):
        truth = self.truth
        self.loc_mod.localize_many = self.localize_many
        self.engine = None
        self.caps = None
        return truth


def _plant(fault: str, engine, loc_mod) -> None:
    """Break the timed path for the benchmark's own tests: "unchanged"
    (every query's pose left as it came in), "half" (half the queries left
    out), "answer" (each pose moved where it is produced), and the
    detection faults of ``rooms.altered_detections``."""
    if fault in rooms.DETECTION_FAULTS:
        engine._run_detector = rooms.altered_detections(
            engine._run_detector, fault)
        return
    real = loc_mod.localize_many

    def broken(store, first, *a, **k):
        before = [c.inv_pose.copy() for c in store.captures[first:]]
        out = real(store, first, *a, **k)
        for i, c in enumerate(store.captures[first:]):
            if fault == "unchanged" or (fault == "half"
                                        and i < len(before) // 2):
                c.inv_pose[:] = before[i]
            elif fault == "answer":
                c.inv_pose[:] += 0.01
        return out
    loc_mod.localize_many = broken


def outputs_of(records) -> list:
    """(photo, detections, pose, call) of every query of every call."""
    return [(k, d, p, i) for i, r in enumerate(records) if r
            for k, d, p in zip(r["photos"], r["dets"], r["poses"])]


def reference_poses(truth: Truth, items, map_tags, device,
                    precision: str = "f64", focal=None):
    """The plain reference's pose of each (photo, detections) item, from
    the photo's rendered pose, over the detections of map tags."""
    tids = sorted(map_tags)
    index = {t: i for i, t in enumerate(tids)}
    f64 = torch.float64
    tags = torch.as_tensor(np.stack([truth.tag_pose[t] for t in tids]),
                           dtype=f64, device=device)
    k_max = max(1, max(sum(t in index for t, _ in d) for _, d in items))
    q = len(items)
    ti = np.zeros((q, k_max), np.int64)
    obs = np.zeros((q, k_max, 4, 2))
    mask = np.zeros((q, k_max), bool)
    for qi, (_, dets) in enumerate(items):
        j = 0
        for t, c in dets:
            if t in index:
                ti[qi, j], obs[qi, j], mask[qi, j] = index[t], c, True
                j += 1
    start = np.stack([truth.scene.inv_poses[k] for k, _ in items])

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    poses = L.localize(truth.scene.focal if focal is None else focal,
                       tags, dev(ti), dev(obs, f64), dev(mask),
                       dev(start, f64), truth.scene.aruco_size, precision)
    # each item's cost and block count in float64 at the found pose
    r = G.residuals(
        torch.as_tensor(truth.scene.focal, dtype=f64, device=device),
        poses.to(f64).repeat_interleave(k_max, 0), tags[dev(ti).reshape(-1)],
        dev(obs, f64).reshape(-1, 4, 2), truth.scene.aruco_size)
    r = torch.where(dev(mask).reshape(-1, 1), r, 0.0).reshape(q, -1)
    cost = 0.5 * (r * r).sum(1)
    return (poses.to(f64).cpu().numpy(), cost.cpu().numpy(),
            mask.sum(1))


def lm_numbers(truth: Truth, records, map_tags, device) -> dict:
    """pose_gap: the largest gap of a query's pose to the reference's over
    its detections; rmse_gap_px: of a call's rmse to the reference's."""
    # the reference once per distinct (photo, detections)
    distinct, key_of = {}, []
    for k, dets, _, _ in outputs_of(records):
        key = (k, tuple((t, c.tobytes()) for t, c in dets))
        distinct.setdefault(key, (k, dets))
        key_of.append(key)
    keys = list(distinct)
    ref_pose, ref_cost, n_blocks = reference_poses(
        truth, [distinct[k] for k in keys], map_tags, device)
    at = {k: i for i, k in enumerate(keys)}
    pose_gap = 0.0
    per_call = {}
    for key, (k, _, pose, call) in zip(key_of, outputs_of(records)):
        i = at[key]
        pose_gap = max(pose_gap, float(np.abs(pose - ref_pose[i]).max()))
        c, n = per_call.get(call, (0.0, 0))
        per_call[call] = (c + ref_cost[i], n + n_blocks[i])
    return {"pose_gap": pose_gap,
            "rmse_gap_px": max(abs(records[call]["rmse"] - float(np.sqrt(
                2.0 * c / (8 * n)))) for call, (c, n) in per_call.items())}


def _map_tags(cfg: dict, truth: Truth) -> set:
    return {D.tag_id(n, m) for k in cfg["map_photos"]
            for n, m, *_ in truth.sightings[k]}


def check(ctx, truth: Truth, records, limits: dict) -> dict:
    cfg = ctx.cfg
    records = [r for r in records if r]
    plain = rooms.plain_detections(truth, list(cfg["query_photos"]), cfg)
    got = rooms.detection_numbers(
        truth, [(k, d) for k, d, _, _ in outputs_of(records)], plain,
        cfg["min_side_px"])
    got.update(lm_numbers(truth, records, _map_tags(cfg, truth), ctx.device))
    return {k: (got[k], limits[k]) for k in limits}


def control(ctx, truth: Truth, records, precision: str) -> dict:
    """The numbers of the plain reference put in the program's place, a
    stage at a time: the plain detector with its corner arithmetic in
    bfloat16 held to the plain detector; the pose-only LM in ``precision``
    over each required tag's corners projected from the scene's poses."""
    cfg = ctx.cfg
    queries = list(cfg["query_photos"])
    plain = rooms.plain_detections(truth, queries, cfg)
    low = rooms.plain_detections(truth, queries, cfg, "bf16")
    got = rooms.detection_numbers(
        truth, [(k, [(t, c - truth.center) for t, c in low[k]])
                for k in queries], plain, cfg["min_side_px"])
    map_tags = _map_tags(cfg, truth)
    dt = G.dtype_of(precision)
    fake = []
    for r in records:
        if not r:
            continue
        dets_all = []
        for k in r["photos"]:
            seen = [s for s in truth.sightings[k]]
            tags = torch.as_tensor(np.stack([truth.tag_pose[D.tag_id(n, m)]
                                             for n, m, *_ in seen]),
                                   dtype=dt, device=ctx.device)
            caps = torch.as_tensor(truth.scene.inv_poses[k], dtype=dt,
                                   device=ctx.device).expand(len(seen), 6)
            uv = G.project(torch.as_tensor(truth.scene.focal, dtype=dt),
                           caps, tags, truth.scene.aruco_size, precision)
            dets_all.append([(D.tag_id(n, m), c) for (n, m, *_), c in zip(
                seen, uv.double().cpu().numpy())])
        items = list(zip(r["photos"], dets_all))
        poses, cost, n = reference_poses(truth, items, map_tags, ctx.device,
                                         precision)
        fake.append({"photos": r["photos"], "dets": dets_all,
                     "poses": list(poses),
                     "rmse": float(np.sqrt(2.0 * cost.sum()
                                           / (8 * n.sum())))})
    got.update(lm_numbers(truth, fake, map_tags, ctx.device))
    return got
