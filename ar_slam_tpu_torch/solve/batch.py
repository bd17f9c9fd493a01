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

A flush uploads its seed tables in one copy (``pack_waves``: the JAX
package's (W, S) slot tables) and its activity masks in another
(``_WaveRunner._masks``); ``seed_waves`` applies the tables with no host
read.  On a CUDA device the seeds and every single-device LM (the waves,
the warmups, the polish, the host-stepped progress calls, the flat hooks
of an ``assemble_fn``) replay CUDA graphs (solve/graphs.py), one capture
of each serving every flush of a runner; ``graphs=False`` runs the same
stages eagerly, bit for bit the same.

With a ``mesh`` (or ``config.dist.num_devices > 1``) the tags are sharded
over it and every LM runs the tag-sharded distributed solve
(parallel/dist_lm.py) on the grouped hooks, and a flush's seeds its one
``seed`` stage over the same padded tables in the shards' numbering; the
waves and warmups are the single-device path's.  On a CUDA mesh, its
shards on one card or spread over several, both replay CUDA graphs
(``dist_lm.graphed_mesh``), one capture of each serving every flush;
``graphs=False`` and the CPU run the same stages eagerly.  Progress
printing is single-device only, as in the reference.
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
from ar_slam_tpu_torch.graph.arrays import (bucket_size, export_arrays,
                                            obs_bucket, write_back)
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.solve.lm import TERMINATION_REASONS, LMConfig, lm_solve
from ar_slam_tpu_torch.solve.residuals import total_cost

logger = logging.getLogger(__name__)


def pack_waves(waves, slots: int, w_min: int = 1) -> np.ndarray:
    """A flush's seed tables, the JAX package's (W, S) slot tables
    (ar_slam_tpu/solve/batch.py:579-605), as one int64 host array
    (W, 2 + 5 S) for one upload: per wave its row [seed_cap, seed_block,
    wave_tags (S), wave_rows (S), wave_mask (S), anchor_rows (S),
    anchor_mask (S)].  W = max(bucket_size(len(waves), floor=1), w_min)
    and S = ``slots``; padding waves have seed_block -1 and padding slots
    row 0, masked.  A wave is (seed_cap, seed_row, tag_rows, tags,
    anchor_rows)."""
    s = slots
    out = np.zeros((max(bucket_size(len(waves), floor=1), w_min), 2 + 5 * s),
                   dtype=np.int64)
    out[:, 1] = -1
    for w, (seed_cap, seed_row, rows, tags, anchors) in enumerate(waves):
        out[w, 0:2] = seed_cap, seed_row
        out[w, 2:2 + len(tags)] = tags
        out[w, 2 + s:2 + s + len(rows)] = rows
        out[w, 2 + 2 * s:2 + 2 * s + len(rows)] = 1
        out[w, 2 + 3 * s:2 + 3 * s + len(anchors)] = anchors
        out[w, 2 + 4 * s:2 + 4 * s + len(anchors)] = 1
    return out


def seed_waves(camera, cap_poses, tag_poses, tag_idx, corners, tables, *,
               aruco_size, seed_mode) -> tuple:
    """Seed the waves of ``tables`` (``pack_waves``, on the device) in
    order, with no host read (≙ the JAX package's
    ``apply_wave_seeds_multi``): a static loop over the W waves, each
    seeding its capture from its anchors where seed_block >= 0 (selected
    by ``torch.where``, as JAX's ``lax.cond``), then initializing the
    tags first seen in it through that capture.  Padding slots scatter
    into one spare tag row that is cut off (JAX's ``mode="drop"``).
    Returns new (cap_poses, tag_poses)."""
    s = (tables.shape[1] - 2) // 5
    seed_caps, seed_blocks = tables[:, 0], tables[:, 1]
    wave_tags, wave_rows, wave_mask, anchor_rows, anchor_mask = (
        tables[:, 2 + k * s:2 + (k + 1) * s] for k in range(5))
    wave_mask, anchor_mask = wave_mask != 0, anchor_mask != 0
    n_tags = tag_poses.shape[0]
    init_corners = corners[wave_rows]  # (W, S, 4, 2)
    anc_corners = corners[anchor_rows]
    anc_tags = tag_idx[anchor_rows]  # (W, S)
    targets = torch.where(wave_mask, wave_tags,
                          torch.full_like(wave_tags, n_tags))
    cap_poses = cap_poses.clone()
    tag_poses = torch.cat([tag_poses, tag_poses[:1]])
    for w in range(tables.shape[0]):
        cap = seed_caps[w:w + 1]
        pose = seed_capture_pose_multi(
            anc_corners[w], camera, tag_poses.index_select(0, anc_tags[w]),
            anchor_mask[w], aruco_size, mode=seed_mode)
        pose = torch.where(seed_blocks[w] >= 0, pose,
                           cap_poses.index_select(0, cap)[0])
        cap_poses.index_copy_(0, cap, pose[None])
        tag_poses.index_copy_(0, targets[w], seed_tag_pose(
            init_corners[w], camera, pose, aruco_size, mode=seed_mode))
    return cap_poses, tag_poses[:n_tags]


def apply_wave_seeds(camera, cap_poses, tag_poses, tag_idx, corners, wave,
                     aruco_size, seed_mode):
    """Seed one wave: ``apply_wave_seeds_multi`` of ``[wave]``.  Returns
    new (cap_poses, tag_poses)."""
    return apply_wave_seeds_multi(camera, cap_poses, tag_poses, tag_idx,
                                  corners, [wave], aruco_size, seed_mode)


def apply_wave_seeds_multi(camera, cap_poses, tag_poses, tag_idx, corners,
                           waves, aruco_size, seed_mode, slots=None,
                           w_min: int = 1, graphs: bool = True):
    """Seed a sequence of waves in order (``seed_waves``) from one upload
    of their tables (``pack_waves`` at ``slots``, by default the largest
    list's ``obs_bucket``).  A wave is (seed_cap, seed_row, tag_rows,
    tags, anchor_rows): with seed_row >= 0 the capture is seeded from its
    anchors (block rows of already-initialized tags), then each tag first
    seen in the wave is initialized through the wave's capture from its
    block row.  On a CUDA device with ``graphs`` the stage replays a CUDA
    graph (solve/graphs.py), bit for bit the eager stage.  Returns new
    (cap_poses, tag_poses)."""
    if slots is None:
        slots = obs_bucket(max((len(x) for w in waves for x in w[2:]),
                               default=1))
    tables = torch.as_tensor(pack_waves(waves, slots, w_min),
                             device=corners.device)
    kw = dict(aruco_size=aruco_size, seed_mode=seed_mode)
    if graphs and corners.device.type == "cuda":
        from ar_slam_tpu_torch.solve.graphs import seed_waves_graphed

        return seed_waves_graphed(camera, cap_poses, tag_poses, tag_idx,
                                  corners, tables, **kw)
    return seed_waves(camera, cap_poses, tag_poses, tag_idx, corners, tables,
                      **kw)


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
                 device, camera_cfg=None, assemble_fn=None, mesh=None,
                 graphs=True):
        self.store = store
        self.graphs = graphs
        self.aruco_size = aruco_size
        self.device = device
        self.assemble_fn = assemble_fn
        self.config = _lm_config(solver_cfg, camera_cfg)
        self.progress = mesh is None and getattr(
            solver_cfg, "minimizer_progress_to_stdout", False)
        self.seed_mode = getattr(solver_cfg, "seed_mode", "hybrid")
        self.seed_anchors = getattr(solver_cfg, "seed_anchors", "multi")
        self.warmup = getattr(solver_cfg, "warmup_new_captures", True)
        self.wave_budget = solver_cfg.max_iterations
        # a flush's seed tables pad their waves to at least the
        # optimize_every bucket, so one seed program serves every flush
        self.w_fixed = bucket_size(
            max(getattr(solver_cfg, "optimize_every", 1), 1), floor=1)
        arrs = export_arrays(store, dtype=np.float64)
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
        self.arrs = arrs
        self._dist = None
        if mesh is None:
            t = arrays_from_numpy(arrs, device, dtype)
            self.camera, self.cap_poses, self.tag_poses = (
                t["camera"], t["cap_poses"], t["tag_poses"])
            self.cap_idx, self.tag_idx, self.corners = (
                t["cap_idx"], t["tag_idx"], t["corners"])
        else:
            from ar_slam_tpu_torch.parallel.dist_lm import (
                TagShardedProblem, make_dist_wave_solver)

            # tag state lives sharded, in the renumbered order
            prob = TagShardedProblem(mesh, arrs.cap_idx, arrs.tag_idx,
                                     arrs.corners, arrs.block_mask,
                                     self.t_pad, dtype=dtype)
            self._prob = prob
            self.tag_poses = prob.put_tags(arrs.tag_poses)
            self.camera, self.cap_poses = prob.put_rep(arrs.camera,
                                                       arrs.cap_poses)
            self._dist = make_dist_wave_solver(
                prob, aruco_size=aruco_size, config=self.config,
                seed_mode=self.seed_mode, graphs=graphs)
        self.active_caps: set[int] = set()
        self.active_blocks = np.zeros_like(arrs.block_mask)
        self.tag_initialized = np.zeros(self.t_pad, dtype=bool)
        self.active_tags = np.zeros(self.t_pad, dtype=bool)
        self.last_info = None
        # queued waves: (cap_index, seed_row, tag_rows, tags, anchor_rows)
        self._pending: list[tuple] = []

    def _mask(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, dtype=bool), device=self.device)

    def _masks(self, *arrays) -> list:
        """Host bool arrays on the device in one upload (views of one
        buffer).  The first is the camera's flag pair (True, False)."""
        arrays = [np.array([True, False])] + [np.asarray(a, dtype=bool)
                                              for a in arrays]
        flat = torch.as_tensor(np.concatenate(arrays), device=self.device)
        return list(torch.split(flat, [a.size for a in arrays]))

    def _lm(self, cam_active, cap_active, tag_active, enabled, budget,
            block_mask=None, lam0=None, nu0=None):
        """One LM over the active sets: numpy masks on the mesh path, else
        device masks (``block_mask`` the active blocks' one, ``cam_active``
        a bool tensor) from one ``_masks`` upload a flush."""
        if self._dist is not None:
            prob = self._prob
            cam_a, cap_a = prob.put_rep(np.asarray(cam_active), cap_active)
            (self.camera, self.cap_poses, self.tag_poses,
             info) = self._dist.lm(
                self.camera, self.cap_poses, self.tag_poses,
                prob.block_mask(self.active_blocks), cam_a, cap_a,
                prob.put_tag_mask(tag_active), enabled=enabled,
                iter_budget=budget)
            return info
        (self.camera, self.cap_poses, self.tag_poses, info) = lm_solve(
            self.camera, self.cap_poses, self.tag_poses, self.cap_idx,
            self.tag_idx, self.corners, block_mask, cam_active, cap_active,
            tag_active, aruco_size=self.aruco_size, config=self.config,
            assemble_fn=self.assemble_fn, enabled=enabled,
            iter_budget=budget, obs_per_tag=self.obs_per_tag,
            obs_per_cap=self.obs_per_cap, row_slots=self.row_slots,
            tag_rows=self.tag_rows, cap_rows=self.cap_rows, lam0=lam0,
            nu0=nu0, graphs=self.graphs)
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

        if self._dist is not None:
            self.cap_poses, self.tag_poses = self._dist.seed_waves(
                self.camera, self.cap_poses, self.tag_poses, waves,
                slots=self.obs_per_cap, w_min=self.w_fixed)
            cam_on, cam_off, blocks = True, False, None
            caps, tags = cap_active, self.active_tags.copy()
            warm_c, warm_t = warm_caps, warm_tags
        else:
            self.cap_poses, self.tag_poses = apply_wave_seeds_multi(
                self.camera, self.cap_poses, self.tag_poses, self.tag_idx,
                self.corners, waves, self.aruco_size, self.seed_mode,
                slots=self.obs_per_cap, w_min=self.w_fixed,
                graphs=self.graphs)
            (cam, blocks, caps, tags, warm_c,
             warm_t) = self._masks(self.active_blocks, cap_active,
                                   self.active_tags, warm_caps, warm_tags)
            cam_on, cam_off = cam[0], cam[1]
        # register-then-refine: solve only the flush's new captures + tags
        # against the frozen established map first (skipped for a brand-new
        # map, where nothing established exists, for polish passes and
        # under progress printing)
        if (lm_enabled and self.warmup and iter_budget is None
                and warm_caps.any() and (cap_active & ~warm_caps).any()
                and not self.progress):
            self._lm(cam_off, warm_c, warm_t, True, budget, blocks)
        if lm_enabled and self.progress:
            self.last_info = self._lm_host_stepped(cam_on, caps, tags, blocks,
                                                   budget)
            return self.last_info
        info = self._lm(cam_on, caps, tags, lm_enabled, budget, blocks)
        self.last_info = info
        return info

    def _lm_host_stepped(self, cam_active, cap_active, tag_active,
                         block_mask, budget: int):
        """One LM iteration per call, printing ceres-style progress lines
        (≙ minimizer_progress_to_stdout, ar_slam_util.cpp:1012).  lam and
        nu carry over through lam0 / nu0, so the damping schedule is the
        one-call solve's.  ``budget`` is the wave's iteration budget.  On
        the card each call is a load and replays of the LM program (as
        the JAX package jits each call), the costs bit for bit the eager
        stepping's."""
        lam, nu = self.config.initial_lambda, 2.0
        prev_cost = None
        t_start = time.time()
        print("iter      cost      cost_change  |gradient|  "
              "tr_radius   iter_time  total_time")
        info = None
        for it in range(min(budget, self.config.max_iterations)):
            t0 = time.time()
            info = self._lm(cam_active, cap_active, tag_active, True, 1,
                            block_mask, lam0=lam, nu0=nu)
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

    def _tags_old(self) -> np.ndarray:
        """The tag poses in the store's numbering, on the host (the mesh
        path all-gathers them)."""
        if self._dist is not None:
            return self._prob.tags_to_old(self.tag_poses, self.t_pad)
        return self.tag_poses.cpu().numpy()

    def true_sq_cost(self) -> float:
        """0.5 * sum of RAW squared residuals on the current state."""
        if self._dist is not None:
            t = arrays_from_numpy(self.arrs._replace(
                tag_poses=self._tags_old()), self._prob.mesh.home,
                self.cap_poses.dtype)
            return float(total_cost(
                self.camera, self.cap_poses, t["tag_poses"], t["cap_idx"],
                t["tag_idx"], t["corners"], self._mask(self.active_blocks),
                self.aruco_size, self.config.enable_distortion))
        return float(total_cost(
            self.camera, self.cap_poses, self.tag_poses, self.cap_idx,
            self.tag_idx, self.corners, self._mask(self.active_blocks),
            self.aruco_size, self.config.enable_distortion))

    def finish(self):
        self._flush(lm_enabled=False)
        write_back(self.store, self.camera.cpu().numpy(),
                   self.cap_poses.cpu().numpy(), self._tags_old())
        if self.last_info is not None:
            logger.info("solve done: cost=%s iters(last wave)=%s",
                        float(self.last_info["cost"]),
                        int(self.last_info["iterations"]))


def _resolve(config, dtype, device, mesh):
    """(config, dtype, device, mesh) of a solve.  ``mesh`` wins; else
    ``config.dist.num_devices > 1`` builds a block mesh of that many
    shards on ``device``'s kind (repeated CPU shards, or CUDA cards); a
    mesh's home device is the solve's device.  The mesh path assembles
    grouped and ignores an ``assemble_fn``, as the reference's does."""
    from ar_slam_tpu_torch.config import ArSlamConfig

    config = config or ArSlamConfig()
    dtype = resolve_dtype(dtype if dtype is not None else config.solver.dtype)
    n = getattr(getattr(config, "dist", None), "num_devices", 0)
    if mesh is None and n and n > 1:
        from ar_slam_tpu_torch.parallel.mesh import device_mesh

        mesh = device_mesh(n, resolve_device(device))
    if mesh is not None:
        device = mesh.home
    return config, dtype, resolve_device(device), mesh


def solve(store: MapStore, config=None, dtype=None, device=None,
          assemble_fn=None, mesh=None, graphs: bool = True) -> dict:
    """Batch BFS solve (≙ ArSlamSolver::solve) on ``device`` (default: the
    card when present) in ``dtype`` (default: config.solver.dtype).
    ``assemble_fn`` overrides the normal-equation assembly (the flat
    hooks then run; see lm.lm_solve; the mesh path ignores it).  With
    ``mesh`` (or config.dist.num_devices > 1) each LM runs tag-sharded
    over it.  On a CUDA device the LM and the seeds replay CUDA graphs
    (solve/graphs.py; on a mesh parallel/dist_lm.py); ``graphs=False``
    runs the eager loop instead, bit for bit the same.  Returns {"waves",
    "cost", "rmse"}."""
    config, dtype, device, mesh = _resolve(config, dtype, device, mesh)
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
                         assemble_fn=assemble_fn, mesh=mesh,
                         graphs=graphs)
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
                      device=None, assemble_fn=None, mesh=None,
                      graphs: bool = True) -> dict:
    """Incremental solve (≙ ArSlamSolver::solveIncremental) on ``device``
    in ``dtype`` with ``assemble_fn``, ``mesh`` or ``graphs``, as ``solve``:
    repeatedly attach an unsolved capture that shares an initialized tag
    with the solved set; each attachment re-optimizes the whole active
    problem.  Returns {"waves", "unsolved"}, plus "cost" and "rmse" when a
    wave ran."""
    config, dtype, device, mesh = _resolve(config, dtype, device, mesh)
    if not store.captures:
        return {"waves": 0}
    _maybe_calibrate_focal(store, config)

    runner = _WaveRunner(store, config.solver, config.aruco_size, dtype,
                         device, camera_cfg=config.camera,
                         assemble_fn=assemble_fn, mesh=mesh,
                         graphs=graphs)
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
