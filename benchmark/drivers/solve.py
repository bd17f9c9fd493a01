"""The final joint solve of a large map, one solve after another.

Set-up generates the configuration's synthetic map (its layout and pixel
noise from the configuration's seeds), pads its tables as the map store's
export does, and draws ``starts`` starting points from the configuration's
``start_seed``: every pose of the map moved by N(0, ``start_sigma``).
Every seed solves the same starts in turn; the seed picks the first.  Each
operation is ``ar_slam_tpu_torch.solve.lm.lm_solve`` from the next start,
in turn, with the grouped
hooks of the configuration's linear solver, run to the solver's own
termination, ending with the solved camera and poses on the host.

The comparison: the reprojection cost (float64) at each solve's poses
above the optimum that the plain reference's float64 bundle adjustment
finds from the scene's poses, and the solve's reported cost against the
cost at its poses.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry as G
from benchmark.reference import lm as L
from benchmark.scenes.synthetic import synthetic_map

# the reference's iteration budget: its LM starts at the scene's poses, a
# step from the optimum
REFERENCE_ITERATIONS = 20


def scene(cfg: dict, device) -> dict:
    """The configuration's map: its layout and pixel noise from the
    configuration's seeds."""
    return synthetic_map(cfg["tags"], cfg["captures"], cfg["focal"],
                         tuple(cfg["image_size"]), cfg["aruco_size"],
                         cfg["tag_spacing"], cfg["height"], cfg["noise_px"],
                         cfg["layout_seed"], cfg["noise_seed"], device)


def starts(cfg: dict, truth: dict, n: int) -> list:
    """``n`` starting points (inverse capture poses, tag poses), float64:
    the scene's poses each moved by N(0, ``start_sigma``), drawn from the
    configuration's ``start_seed``."""
    dev = truth["cap_poses"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg["start_seed"]))
    sigma = float(cfg["start_sigma"])
    out = []
    for _ in range(n):
        out.append(tuple(
            truth[k] + sigma * torch.randn(truth[k].shape, generator=gen,
                                           dtype=torch.float64, device=dev)
            for k in ("cap_poses", "tag_poses")))
    return out


def _up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


class Cell:
    def __init__(self, ctx):
        from ar_slam_tpu_torch.graph.arrays import bucket_size
        from ar_slam_tpu_torch.solve.lm import LMConfig, lm_solve

        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        self.ctx = ctx
        self.truth = scene(cfg, dev)
        t = self.truth
        n_c, n_t = t["cap_poses"].shape[0], t["tag_poses"].shape[0]
        n_b = t["cap_idx"].shape[0]
        self.n = (n_c, n_t)
        c_pad, t_pad, b_pad = (bucket_size(n_c), bucket_size(n_t),
                               bucket_size(n_b))
        f32 = torch.float32

        def padded(x, rows, dtype):
            out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=dtype,
                              device=dev)
            out[:x.shape[0]] = x
            return out

        self.tables = dict(
            cap_idx=padded(t["cap_idx"], b_pad, torch.int32),
            tag_idx=padded(t["tag_idx"], b_pad, torch.int32),
            corners=padded(t["corners"], b_pad, f32),
            block_mask=torch.arange(b_pad, device=dev) < n_b,
            cap_active=torch.arange(c_pad, device=dev) < n_c,
            tag_active=torch.arange(t_pad, device=dev) < n_t)
        self.camera = torch.tensor([cfg["focal"], 0.0, 0.0], dtype=f32,
                                   device=dev)
        self.starts = [(padded(c, c_pad, f32), padded(g, t_pad, f32))
                       for c, g in starts(cfg, t, int(mix["starts"]))]
        # every seed solves the same starts; the seed picks the first
        self.first = int(ctx.seed) % len(self.starts)
        s = cfg["solver"]
        tag_counts = torch.bincount(t["tag_idx"]).cpu().numpy()
        cap_counts = torch.bincount(t["cap_idx"]).cpu().numpy()
        self.bounds = dict(obs_per_tag=_up(tag_counts.max(), 8),
                           obs_per_cap=_up(cap_counts.max(), 8))
        if s["linear_solver"] == "cg":
            rs = int(s["row_slots"])
            self.bounds.update(
                row_slots=rs,
                tag_rows=_up((-(-tag_counts // rs)).sum(), 256),
                cap_rows=_up((-(-cap_counts // rs)).sum(), 256))
        self.config = LMConfig(max_iterations=int(s["max_iterations"]),
                               linear_solver=s["linear_solver"],
                               cg_tolerance=float(s["cg_tolerance"]),
                               cg_max_iterations=int(s["cg_max_iterations"]))
        self.solve = lm_solve
        if ctx.spans is not None:
            self.solve = ctx.spans.wrap("lm", self.solve)
        if ctx.fault == "unchanged":  # the solve returns its start
            real = self.solve

            def unchanged(camera, caps, tags, *a, **k):
                out = real(camera, caps, tags, *a, **k)
                return (camera, caps, tags, out[3])
            self.solve = unchanged
        self.i = 0
        for _ in range(int(mix["warm_solves"])):
            self.after(self.op())
        self.i = 0

    def op(self):
        k = (self.first + self.i) % len(self.starts)
        self.i += 1
        caps, tags = self.starts[k]
        tb = self.tables
        cam, cp, tp, info = self.solve(
            self.camera, caps, tags, tb["cap_idx"], tb["tag_idx"],
            tb["corners"], tb["block_mask"], True, tb["cap_active"],
            tb["tag_active"], aruco_size=self.ctx.cfg["aruco_size"],
            config=self.config, **self.bounds)
        n_c, n_t = self.n
        return (k, cam.cpu(), cp[:n_c].cpu(), tp[:n_t].cpu(),
                float(info["cost"]), int(info["iterations"]))

    def after(self, res) -> dict:
        k, cam, cp, tp, cost, iterations = res
        if self.ctx.fault == "answer":  # the poses altered where produced
            tp = tp + 1e-3
        return {"start": k, "focal": float(cam[0]), "caps": cp, "tags": tp,
                "cost": cost, "iterations": iterations,
                "failed": not np.isfinite(cost)}

    def counters(self, records) -> dict:
        return {"solves": len(records),
                "iterations": sum(r["iterations"] for r in records if r)}

    def end_to_end(self, records, latencies, window_s) -> dict:
        return {"solve_s": window_s / len(records)}

    def release(self):
        self.tables = self.starts = None
        return self.truth


def check(ctx, truth: dict, records, limits: dict) -> dict:
    got = numbers(truth, [r for r in records if r], ctx.cfg)
    return {k: (got[k], limits[k]) for k in limits}


def numbers(truth: dict, records, cfg: dict, ref=None) -> dict:
    """cost_gap: the largest (cost at a solve's poses - the reference's
    optimum) / the optimum; cost_echo: the largest |reported cost - cost at
    its poses| / the cost at its poses."""
    size = cfg["aruco_size"]
    ci, ti, obs = truth["cap_idx"], truth["tag_idx"], truth["corners"]
    if ref is None:
        f, cp, tp, _ = L.bundle_adjust(
            truth["focal"], truth["cap_poses"], truth["tag_poses"], ci, ti,
            obs, size, "f64", max_iterations=REFERENCE_ITERATIONS,
            rtol=1e-10)
        ref = G.cost(f, cp, tp, ci, ti, obs, size)
        del cp, tp
    gap = echo = 0.0
    dev = ci.device
    for r in records:
        c = G.cost(r["focal"], r["caps"].to(dev), r["tags"].to(dev), ci, ti,
                   obs, size)
        gap = max(gap, (c - ref) / ref)
        echo = max(echo, abs(r["cost"] - c) / c)
    return {"cost_gap": gap, "cost_echo": echo, "optimum": ref}


def control(ctx, truth: dict, records, precision: str) -> dict:
    """The numbers of the plain reference put in the program's place and
    computed in ``precision``: its bundle adjustment from each start the
    records used."""
    cfg = ctx.cfg
    size = cfg["aruco_size"]
    caps, tags = starts(cfg, truth, int(ctx.mix["starts"]))[
        int(ctx.seed) % int(ctx.mix["starts"])]
    f, cp, tp, it = L.bundle_adjust(
        truth["focal"], caps, tags, truth["cap_idx"], truth["tag_idx"],
        truth["corners"], size, precision,
        max_iterations=int(cfg["solver"]["max_iterations"]))
    # the control's own cost, in its precision, as the program reports one
    c = float(L._cost(f, cp, tp, truth["cap_idx"].to(torch.int64),
                      truth["tag_idx"].to(torch.int64),
                      truth["corners"].to(G.dtype_of(precision)), size,
                      precision))
    rec = {"focal": float(f), "caps": cp.double().cpu(),
           "tags": tp.double().cpu(), "cost": c, "iterations": it}
    return numbers(truth, [rec], cfg)
