"""A map rebuilt from its recorded sightings, one map after another.

Set-up generates the configuration's synthetic map (its layout and pixel
noise from the configuration's seeds) and holds its sightings on the host
as an event log's ``detections`` records, in capture order: per capture its
uid, the image size and per sighting the tag id and the four centered
corners.  Each operation is what ``arslam-torch replay`` does with such a
log, in memory: a fresh ``ArSlamEngine`` with the configuration's engine
settings, ``store.add_detections`` of every capture, then ``solve()``
(focal self-calibration, the BFS waves flushed every ``optimize_every``
with their seeds, warmups and joint LMs), ending with the camera and every
pose in the map store on the host.  No file is written.

The comparison: the reprojection cost (float64) at the map's poses above
the optimum that the plain reference's float64 bundle adjustment finds
from the scene's poses, the map's rmse against the one at its poses, and
the captures and tags of the connected capture-tag graph that the map
leaves out or unsolved.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.drivers import solve as S
from benchmark.reference import geometry as G
from benchmark.reference import lm as L


def uid_of(k: int) -> str:
    return f"cap_{k}"


def id_of(t: int) -> str:
    return f"aruco_4X4_50_{t}"


def event_log(truth: dict, image_size) -> list:
    """The scene's sightings as an event log's ``detections`` records, in
    capture order: corners as the log holds them, 8 numbers a sighting."""
    ci = truth["cap_idx"].cpu().numpy()
    ti = truth["tag_idx"].cpu().numpy()
    corners = truth["corners"].cpu().numpy().reshape(-1, 8)
    starts = np.flatnonzero(np.diff(ci, prepend=-1))
    ends = np.append(starts[1:], ci.size)
    return [{"kind": "detections", "uid": uid_of(int(ci[a])), "path": "",
             "width": int(image_size[0]), "height": int(image_size[1]),
             "detections": [{"id": id_of(int(ti[j])),
                             "corners": corners[j].tolist()}
                            for j in range(a, b)]}
            for a, b in zip(starts, ends)]


def connected(truth: dict, seed: int = 0) -> tuple:
    """(captures, tags) of the capture-tag graph reachable from capture
    ``seed``, as sorted index arrays."""
    ci = truth["cap_idx"].cpu().numpy()
    ti = truth["tag_idx"].cpu().numpy()
    caps, tags = {seed}, set()
    frontier = {seed}
    while frontier:
        new_tags = set(ti[np.isin(ci, list(frontier))].tolist()) - tags
        tags |= new_tags
        frontier = set(ci[np.isin(ti, list(new_tags))].tolist()) - caps
        caps |= frontier
    return np.array(sorted(caps)), np.array(sorted(tags))


def engine_config(cfg: dict):
    """The engine's configuration: the CLI's defaults, the tag size, and the
    configuration's solver settings."""
    from ar_slam_tpu_torch.config import ArSlamConfig, SolverConfig

    s = cfg["solver"]
    return ArSlamConfig(
        aruco_size=cfg["aruco_size"],
        solver=SolverConfig(linear_solver=s["linear_solver"],
                            max_iterations=s["max_iterations"],
                            dtype=s["dtype"],
                            optimize_every=s["optimize_every"]))


class Cell:
    def __init__(self, ctx):
        cfg, mix = ctx.cfg, ctx.mix
        self.ctx = ctx
        self.truth = S.scene(cfg, ctx.device)
        self.log = event_log(self.truth, cfg["image_size"])
        self.n = (self.truth["cap_poses"].shape[0],
                  self.truth["tag_poses"].shape[0])
        self.n_connected = len(connected(self.truth)[0])
        self.config = engine_config(cfg)
        self.sightings = int(self.truth["cap_idx"].numel())
        for _ in range(int(mix["warm_calls"])):
            self.after(self.op())

    def op(self):
        from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine

        spans = self.ctx.spans
        engine = ArSlamEngine(self.config, device=self.ctx.device)
        store = engine.store
        for rec in self.log:  # as ``arslam-torch replay`` reads its log
            dets = [(d["id"], np.asarray(d["corners"]).reshape(4, 2))
                    for d in rec["detections"]]
            store.add_detections(rec["uid"], dets,
                                 (rec["width"], rec["height"]),
                                 rec["path"])
        solve = engine.solve
        if spans is not None:
            solve = spans.wrap("solve", solve)
        summary = solve()
        return store, summary

    def after(self, res) -> dict:
        store, summary = res
        n_c, n_t = self.n
        caps = np.full((n_c, 6), np.nan)
        tags = np.full((n_t, 6), np.nan)
        solved = np.zeros(n_c, dtype=bool)
        for k in range(n_c):
            i = store.capture_map.get(uid_of(k))
            if i is not None:
                caps[k] = store.captures[i].inv_pose
                solved[k] = i not in store.unsolved_captures
        for t in range(n_t):
            i = store.aruco_map.get(id_of(t))
            if i is not None:
                tags[t] = store.arucos[i].pose
        if self.ctx.fault == "answer":  # the map altered where produced
            tags = tags + 0.002
        if self.ctx.fault == "unchanged":  # the solve left its start
            tags = np.zeros_like(tags)
        rec = {"rmse": summary.get("rmse", float("nan")),
               "waves": summary.get("waves", 0),
               "focal": float(store.camera.params[0]), "caps": caps,
               "tags": tags, "solved": solved}
        rec["failed"] = (rec["waves"] != self.n_connected
                         or not np.isfinite(rec["rmse"]))
        return rec

    def counters(self, records) -> dict:
        maps = len(records)
        return {"maps": maps, "captures": len(self.log) * maps,
                "sightings": self.sightings * maps}

    def end_to_end(self, records, latencies, window_s) -> dict:
        return {"map_s": window_s / len(records)}

    def release(self):
        self.log = None
        return self.truth


def optimum(truth: dict, cfg: dict) -> float:
    """The float64 reprojection cost at the plain reference's bundle
    adjustment from the scene's poses."""
    f, cp, tp, _ = L.bundle_adjust(
        truth["focal"], truth["cap_poses"], truth["tag_poses"],
        truth["cap_idx"], truth["tag_idx"], truth["corners"],
        cfg["aruco_size"], "f64", max_iterations=S.REFERENCE_ITERATIONS,
        rtol=1e-10)
    return G.cost(f, cp, tp, truth["cap_idx"], truth["tag_idx"],
                  truth["corners"], cfg["aruco_size"])


def map_numbers(truth: dict, records, cfg: dict, ref=None) -> dict:
    """cost_gap: the largest (cost at a map's poses - the reference's
    optimum) / the optimum; rmse_gap_px: of a map's rmse to the one at its
    poses; unsolved_captures / missing_tags: the most captures / tags of
    the connected graph that a map leaves out, unsolved or unplaced (a
    pose not finite, or a tag's never moved from zero)."""
    ci, ti, obs = truth["cap_idx"], truth["tag_idx"], truth["corners"]
    size = cfg["aruco_size"]
    if ref is None:
        ref = optimum(truth, cfg)
    caps, tags = connected(truth)
    dev = ci.device
    out = dict.fromkeys(("cost_gap", "rmse_gap_px", "unsolved_captures",
                         "missing_tags"), 0.0)
    for r in records:
        cp = torch.as_tensor(r["caps"], dtype=torch.float64, device=dev)
        tp = torch.as_tensor(r["tags"], dtype=torch.float64, device=dev)
        c = G.cost(r["focal"], cp, tp, ci, ti, obs, size)
        rmse = float(np.sqrt(2.0 * c / (8 * ci.numel())))
        placed = np.isfinite(r["tags"]).all(1) & (r["tags"] != 0).any(1)
        cap_ok = r["solved"] & np.isfinite(r["caps"]).all(1)
        out["cost_gap"] = max(out["cost_gap"], (c - ref) / ref)
        out["rmse_gap_px"] = max(out["rmse_gap_px"], abs(r["rmse"] - rmse))
        out["unsolved_captures"] = max(out["unsolved_captures"],
                                       float((~cap_ok[caps]).sum()))
        out["missing_tags"] = max(out["missing_tags"],
                                  float((~placed[tags]).sum()))
    print(f"benchmark: optimum {ref}", file=sys.stderr)
    return out


def check(ctx, truth: dict, records, limits: dict) -> dict:
    got = map_numbers(truth, [r for r in records if r], ctx.cfg)
    return {k: (got[k], limits[k]) for k in limits}


def control(ctx, truth: dict, records, precision: str) -> dict:
    """The numbers of the plain reference put in the program's place and
    computed in ``precision``: its bundle adjustment of the sightings from
    the scene's poses, with its own rmse in that precision, as the program
    reports one."""
    cfg = ctx.cfg
    size = cfg["aruco_size"]
    ci = truth["cap_idx"].to(torch.int64)
    ti = truth["tag_idx"].to(torch.int64)
    f, cp, tp, _ = L.bundle_adjust(
        truth["focal"], truth["cap_poses"], truth["tag_poses"], ci, ti,
        truth["corners"], size, precision,
        max_iterations=int(cfg["solver"]["max_iterations"]))
    c = float(L._cost(f, cp, tp, ci, ti,
                      truth["corners"].to(G.dtype_of(precision)), size,
                      precision))
    rec = {"focal": float(f), "caps": cp.double().cpu().numpy(),
           "tags": tp.double().cpu().numpy(),
           "solved": np.ones(cp.shape[0], dtype=bool),
           "rmse": float(np.sqrt(2.0 * c / (8 * ci.numel())))}
    return map_numbers(truth, [rec], cfg)
