"""Batch BFS and incremental mapping solves (port of
ar_slam_tpu/solve/batch.py:solve and solve_incremental).

``solve`` ≙ ``ArSlamSolver::solve`` (ar_slam_util.cpp:744-866): start at
the capture with the most blocks, walk the capture–tag graph breadth first,
and after each capture (or every ``optimize_every``-th) re-run LM on the
active subproblem.  Pose state stays on the device between waves.  Waves
that do not optimize only queue their seeds; the next optimizing wave
applies the queued seeds in order, then (register-then-refine) solves the
new captures and tags against the frozen map, then runs the joint LM.

``solve_incremental`` ≙ ``ArSlamSolver::solveIncremental``: the solved
captures re-enter the active problem as they are, then each unsolved
capture that sees an initialized tag is attached through it, one
optimizing wave per attachment, until none is left that can be.

With ``linear_solver="cg"`` every LM runs the implicit-Schur CG on the
row-split slot packing, its row budgets sized from the whole store.  With
``minimizer_progress_to_stdout`` the joint LM of each flush runs one
iteration per call and prints a ceres-style line per iteration.
Single-device path only; the mesh path of the reference is not ported.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ar_slam_tpu_torch.convert import arrays_from_numpy
from ar_slam_tpu_torch.core.seeding import (seed_capture_pose_multi,
                                            seed_tag_pose)
from ar_slam_tpu_torch.device import resolve_device, resolve_dtype
from ar_slam_tpu_torch.graph.arrays import export_arrays, obs_bucket, write_back
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.solve.lm import TERMINATION_REASONS, LMConfig, lm_solve
from ar_slam_tpu_torch.solve.residuals import total_cost

logger = logging.getLogger(__name__)


def apply_wave_seeds_multi(camera, cap_poses, tag_poses, tag_idx, corners,
                           waves, aruco_size, seed_mode):
    """Seed a sequence of waves in order.  Each wave is (seed_cap,
    seed_row, tag_rows, tags, anchor_rows): with seed_row >= 0 the capture
    is seeded from its anchors (block rows of already-initialized tags),
    then each tag first seen in the wave is initialized through the wave's
    capture from its block row.  Returns new (cap_poses, tag_poses)."""
    cap_poses = cap_poses.clone()
    tag_poses = tag_poses.clone()
    dev = corners.device
    for seed_cap, seed_row, rows, tags, anchors in waves:
        if seed_row >= 0 and anchors:
            anc = torch.as_tensor(anchors, dtype=torch.int64, device=dev)
            cap_poses[seed_cap] = seed_capture_pose_multi(
                corners[anc], camera, tag_poses[tag_idx[anc]],
                torch.ones(len(anchors), dtype=torch.bool, device=dev),
                aruco_size, mode=seed_mode)
        if rows:
            r = torch.as_tensor(rows, dtype=torch.int64, device=dev)
            t = torch.as_tensor(tags, dtype=torch.int64, device=dev)
            tag_poses[t] = seed_tag_pose(corners[r], camera,
                                         cap_poses[seed_cap], aruco_size,
                                         mode=seed_mode)
    return cap_poses, tag_poses


def _maybe_calibrate_focal(store: MapStore, config) -> None:
    """Self-calibrate the initial focal from tag homographies unless it is
    already trusted or parity mode asks for the fixed init."""
    if store.camera.focal_calibrated:
        return
    if config.camera.focal_init_mode != "homography":
        return
    from ar_slam_tpu_torch.core.calib import estimate_focal

    focal = estimate_focal((b.corners for b in store.blocks),
                           config.aruco_size)
    if focal is not None and np.isfinite(focal) and focal > 10.0:
        logger.info("self-calibrated initial focal: %.1f px", focal)
        store.camera.params[0] = focal
    store.camera.focal_calibrated = True


def _lm_config(cfg, camera_cfg=None) -> LMConfig:
    return LMConfig(
        max_iterations=max(cfg.max_iterations,
                           getattr(cfg, "final_polish_iterations", 0)),
        initial_lambda=cfg.initial_lambda,
        min_lambda=cfg.min_lambda,
        max_lambda=cfg.max_lambda,
        function_tolerance=cfg.function_tolerance,
        parameter_tolerance=cfg.parameter_tolerance,
        gradient_tolerance=getattr(cfg, "gradient_tolerance", 1e-10),
        jacobi_scaling=cfg.jacobi_scaling,
        enable_distortion=bool(getattr(camera_cfg, "enable_distortion",
                                       False)),
        linear_solver=getattr(cfg, "linear_solver", "dense"),
        cg_tolerance=cfg.cg_tolerance,
        cg_max_iterations=cfg.cg_max_iterations,
        loss=getattr(cfg, "loss", "trivial"),
        loss_scale=getattr(cfg, "loss_scale", 4.0),
    )


class _WaveRunner:
    """Device-resident pose state across the waves of one padded export."""

    def __init__(self, store: MapStore, solver_cfg, aruco_size, dtype,
                 device, camera_cfg=None, assemble_fn=None):
        self.store = store
        self.aruco_size = aruco_size
        self.device = device
        self.assemble_fn = assemble_fn
        self.config = _lm_config(solver_cfg, camera_cfg)
        self.progress = getattr(solver_cfg, "minimizer_progress_to_stdout",
                                False)
        self.seed_mode = getattr(solver_cfg, "seed_mode", "hybrid")
        self.seed_anchors = getattr(solver_cfg, "seed_anchors", "multi")
        self.warmup = getattr(solver_cfg, "warmup_new_captures", True)
        self.wave_budget = solver_cfg.max_iterations
        arrs = export_arrays(store, dtype=np.float64)
        t = arrays_from_numpy(arrs, device, dtype)
        self.c_pad = arrs.cap_poses.shape[0]
        self.t_pad = arrs.tag_poses.shape[0]
        self.obs_per_tag = obs_bucket(
            max((len(a.blocks) for a in store.arucos), default=1))
        self.obs_per_cap = obs_bucket(
            max((len(c.blocks) for c in store.captures), default=1))
        # CG solves use the row-split slot packing (schur.TagRows): the row
        # budgets cover the whole store's observations (waves activate
        # subsets), bucketed like the other bounds
        self.row_slots = self.tag_rows = self.cap_rows = None
        if self.config.linear_solver == "cg":
            self.row_slots = 8
            self.tag_rows = obs_bucket(sum(
                -(-max(len(a.blocks), 1) // self.row_slots)
                for a in store.arucos) or 1)
            self.cap_rows = obs_bucket(sum(
                -(-max(len(c.blocks), 1) // self.row_slots)
                for c in store.captures) or 1)
        self.camera, self.cap_poses, self.tag_poses = (
            t["camera"], t["cap_poses"], t["tag_poses"])
        self.cap_idx, self.tag_idx, self.corners = (
            t["cap_idx"], t["tag_idx"], t["corners"])
        self.active_caps: set[int] = set()
        self.active_blocks = np.zeros_like(arrs.block_mask)
        self.tag_initialized = np.zeros(self.t_pad, dtype=bool)
        self.active_tags = np.zeros(self.t_pad, dtype=bool)
        self.last_info = None
        # queued waves: (cap_index, seed_row, tag_rows, tags, anchor_rows)
        self._pending: list[tuple] = []

    def _mask(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, dtype=bool), device=self.device)

    def _lm(self, cam_active, cap_active, tag_active, enabled, budget,
            lam0=None, nu0=None):
        (self.camera, self.cap_poses, self.tag_poses, info) = lm_solve(
            self.camera, self.cap_poses, self.tag_poses, self.cap_idx,
            self.tag_idx, self.corners, self._mask(self.active_blocks),
            cam_active, self._mask(cap_active), self._mask(tag_active),
            aruco_size=self.aruco_size, config=self.config,
            assemble_fn=self.assemble_fn, enabled=enabled,
            iter_budget=budget, obs_per_tag=self.obs_per_tag,
            obs_per_cap=self.obs_per_cap, row_slots=self.row_slots,
            tag_rows=self.tag_rows, cap_rows=self.cap_rows, lam0=lam0,
            nu0=nu0)
        return info

    def polish(self, budget: int):
        """One extra LM pass (no new seeds) with a bigger budget."""
        if budget <= 0:
            return self.last_info
        self._pending.append((0, -1, [], [], []))
        return self._flush(lm_enabled=True, iter_budget=budget)

    def run_wave(self, cap_index: int, seed_block: int | None,
                 optimize: bool = True):
        """Add one capture to the active problem and (optionally)
        re-optimize; optimize=False only queues its seeds."""
        store = self.store
        rows, tags, anchors = [], [], []
        self.active_caps.add(cap_index)
        for bh in store.captures[cap_index].blocks:
            self.active_blocks[bh] = True
            t = store.blocks[bh].tag_idx
            self.active_tags[t] = True
            if not self.tag_initialized[t]:
                self.tag_initialized[t] = True
                rows.append(bh)
                tags.append(t)
            else:
                anchors.append(bh)
        seed_row = -1 if seed_block is None else int(seed_block)
        if seed_row >= 0 and self.seed_anchors != "multi":
            anchors = [seed_row]  # reference parity: the init_block only
        self._pending.append((cap_index, seed_row, rows, tags,
                              anchors if seed_row >= 0 else []))
        if optimize:
            return self._flush(lm_enabled=True)
        return None

    def _flush(self, lm_enabled: bool, iter_budget: int | None = None):
        """Apply the queued seeds and run (up to) the warmup and joint LM."""
        if not self._pending:
            return self.last_info
        budget = int(self.wave_budget if iter_budget is None else iter_budget)
        waves = list(self._pending)
        self._pending.clear()
        warm_caps = np.zeros(self.c_pad, dtype=bool)
        warm_tags = np.zeros(self.t_pad, dtype=bool)
        for cap_index, _, _, tags, _ in waves:
            warm_caps[cap_index] = True
            warm_tags[tags] = True
        cap_active = np.zeros(self.c_pad, dtype=bool)
        cap_active[list(self.active_caps)] = True

        self.cap_poses, self.tag_poses = apply_wave_seeds_multi(
            self.camera, self.cap_poses, self.tag_poses, self.tag_idx,
            self.corners, waves, self.aruco_size, self.seed_mode)
        # register-then-refine: solve only the flush's new captures + tags
        # against the frozen established map first (skipped for a brand-new
        # map, where nothing established exists, for polish passes and
        # under progress printing)
        if (lm_enabled and self.warmup and iter_budget is None
                and warm_caps.any() and (cap_active & ~warm_caps).any()
                and not self.progress):
            self._lm(False, warm_caps, warm_tags, True, budget)
        if lm_enabled and self.progress:
            self.last_info = self._lm_host_stepped(cap_active, budget)
            return self.last_info
        info = self._lm(True, cap_active, self.active_tags.copy(),
                        lm_enabled, budget)
        self.last_info = info
        return info

    def _lm_host_stepped(self, cap_active, budget: int):
        """One LM iteration per call, printing ceres-style progress lines
        (≙ minimizer_progress_to_stdout, ar_slam_util.cpp:1012).  lam and
        nu carry over through lam0 / nu0, so the damping schedule is the
        one-call solve's.  ``budget`` is the wave's iteration budget."""
        lam, nu = self.config.initial_lambda, 2.0
        prev_cost = None
        t_start = time.time()
        print("iter      cost      cost_change  |gradient|  "
              "tr_radius   iter_time  total_time")
        info = None
        for it in range(min(budget, self.config.max_iterations)):
            t0 = time.time()
            info = self._lm(True, cap_active, self.active_tags.copy(), True,
                            1, lam0=lam, nu0=nu)
            cost = float(info["cost"])
            lam, nu = float(info["lambda"]), float(info["nu"])
            dcost = 0.0 if prev_cost is None else prev_cost - cost
            now = time.time()
            print(f"{it:4d}  {cost:11.6e}  {dcost:11.2e}  "
                  f"{float(info['grad_max']):11.2e}  "
                  f"{1.0 / max(lam, 1e-30):10.2e}  {now - t0:9.2e}  "
                  f"{now - t_start:9.2e}")
            prev_cost = cost
            if bool(info["converged"]):
                print("terminating: " + TERMINATION_REASONS.get(
                    int(info["termination"]), "?"))
                break
        if info is not None:
            info = {**info, "iterations": it + 1}
        return info

    def true_sq_cost(self) -> float:
        """0.5 * sum of RAW squared residuals on the current state."""
        return float(total_cost(
            self.camera, self.cap_poses, self.tag_poses, self.cap_idx,
            self.tag_idx, self.corners, self._mask(self.active_blocks),
            self.aruco_size, self.config.enable_distortion))

    def finish(self):
        self._flush(lm_enabled=False)
        write_back(self.store, self.camera.cpu().numpy(),
                   self.cap_poses.cpu().numpy(), self.tag_poses.cpu().numpy())
        if self.last_info is not None:
            logger.info("solve done: cost=%s iters(last wave)=%s",
                        float(self.last_info["cost"]),
                        int(self.last_info["iterations"]))


def _resolve(config, dtype, device):
    """(config, dtype, device) of a solve, refusing what is not ported."""
    from ar_slam_tpu_torch.config import ArSlamConfig

    config = config or ArSlamConfig()
    device = resolve_device(device)
    dtype = resolve_dtype(dtype if dtype is not None else config.solver.dtype)
    if getattr(getattr(config, "dist", None), "num_devices", 0) > 1:
        raise NotImplementedError("the distributed solve is not ported")
    return config, dtype, device


def solve(store: MapStore, config=None, dtype=None, device=None,
          assemble_fn=None) -> dict:
    """Batch BFS solve (≙ ArSlamSolver::solve) on ``device`` (default: the
    card when present) in ``dtype`` (default: config.solver.dtype).
    ``assemble_fn`` overrides the normal-equation assembly (the flat
    hooks then run; see lm.lm_solve).  Returns {"waves", "cost", "rmse"}."""
    config, dtype, device = _resolve(config, dtype, device)
    if not store.captures:
        return {"waves": 0}
    _maybe_calibrate_focal(store, config)
    for cap in store.captures:
        cap.init_block = None

    seed = store.capture_with_most_blocks()
    order = store.connected_component(seed)
    if len(order) < len(store.captures):
        logger.warning("%d captures are disconnected from the seed component "
                       "and stay unsolved", len(store.captures) - len(order))

    runner = _WaveRunner(store, config.solver, config.aruco_size, dtype,
                         device, camera_cfg=config.camera,
                         assemble_fn=assemble_fn)
    every = max(getattr(config.solver, "optimize_every", 1), 1)
    growth = float(getattr(config.solver, "optimize_growth", 0.0) or 0.0)
    geo_marks: set[int] = set()
    if growth > 1.0:
        nxt = 1
        while nxt <= len(order):
            geo_marks.add(nxt - 1)
            nxt = max(nxt + 1, int(np.ceil(nxt * growth)))
    for i, cap_index in enumerate(order):
        seed_block = None
        if cap_index != seed:
            seed_block = store.captures[cap_index].init_block
        optimize = ((i % every == every - 1) or (i == len(order) - 1)
                    or i in geo_marks)
        runner.run_wave(cap_index, seed_block, optimize=optimize)
        store.unsolved_captures.discard(cap_index)
    runner.polish(getattr(config.solver, "final_polish_iterations", 0))
    runner.finish()

    cost = float(runner.last_info["cost"])
    return {"waves": len(order), "cost": cost,
            "rmse": _rmse(runner, config, cost)}


def solve_incremental(store: MapStore, config=None, dtype=None,
                      device=None, assemble_fn=None) -> dict:
    """Incremental solve (≙ ArSlamSolver::solveIncremental) on ``device``
    in ``dtype`` with ``assemble_fn``, as ``solve``: repeatedly attach an
    unsolved capture that shares an initialized tag with the solved set;
    each attachment re-optimizes the whole active problem.  Returns
    {"waves", "unsolved"}, plus "cost" and "rmse" when a wave ran."""
    config, dtype, device = _resolve(config, dtype, device)
    if not store.captures:
        return {"waves": 0}
    _maybe_calibrate_focal(store, config)

    runner = _WaveRunner(store, config.solver, config.aruco_size, dtype,
                         device, camera_cfg=config.camera,
                         assemble_fn=assemble_fn)
    # the solved captures re-enter the active problem without an LM pass:
    # their poses came with the export
    for cap in store.captures:
        if cap.index in store.unsolved_captures:
            continue
        runner.active_caps.add(cap.index)
        for bh in cap.blocks:
            runner.active_blocks[bh] = True
            t = store.blocks[bh].tag_idx
            runner.active_tags[t] = True
            runner.tag_initialized[t] = True

    waves = 0
    if len(store.unsolved_captures) == len(store.captures):
        first = min(store.unsolved_captures)
        logger.info("Solving initial capture %d", first)
        store.unsolved_captures.discard(first)
        runner.run_wave(first, None)
        waves += 1

    repeat = True
    while repeat:
        repeat = False
        for cap_index in sorted(store.unsolved_captures):
            cap = store.captures[cap_index]
            connect = next((bh for bh in cap.blocks if runner.tag_initialized[
                store.blocks[bh].tag_idx]), None)
            if connect is not None:
                logger.info("Capture %s can be solved through %s", cap.uid,
                            store.arucos[store.blocks[connect].tag_idx].id)
                store.unsolved_captures.discard(cap_index)
                runner.run_wave(cap_index, connect)
                waves += 1
                repeat = True
                break
    runner.finish()
    out = {"waves": waves, "unsolved": len(store.unsolved_captures)}
    if runner.last_info is not None:
        out["cost"] = float(runner.last_info["cost"])
        out["rmse"] = _rmse(runner, config, out["cost"])
    return out


def _rmse(runner: _WaveRunner, config, cost: float) -> float:
    """Reprojection RMSE of the runner's active blocks: from the LM cost,
    or under a robust loss from the raw squared residuals."""
    sq = cost if config.solver.loss == "trivial" else runner.true_sq_cost()
    return rmse_from_cost(sq, int(np.sum(runner.active_blocks)))


def rmse_from_cost(cost: float, n_blocks: int) -> float:
    """Reprojection RMSE in pixels from 0.5*sum-sq cost over 8-residual
    blocks."""
    if n_blocks == 0:
        return 0.0
    return float(np.sqrt(2.0 * cost / (8 * n_blocks)))
