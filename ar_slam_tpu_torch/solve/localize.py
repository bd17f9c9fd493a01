"""Map-based localization: pose-only solves against a frozen map (port of
ar_slam_tpu/solve/localize.py).

≙ ``ArSlamSolver::localizeMany`` / ``localizeOne``
(ar_slam_util.cpp:888-979): each query capture is seeded from a block whose
tag is shared with a map capture, then optimized alone with tag poses and
camera intrinsics constant.  Every query is an independent 6-unknown
problem, so all of them run at once, each query with its own lambda,
acceptance and convergence, for at most ``max_iterations`` LM iterations.
``localize_init`` (the seeds) reads nothing back.  On the card the whole
loop is one launch of K5 (``localize_lm``, csrc/localize.cu) after it, as
the JAX package's ``localize_kernel`` is one program with a device
``while_loop``; its plain twin, run off the card, is the host's loop over
``localize_iteration`` (one iteration) with one read per iteration to
stop when every query has converged.  Both are stages of
solve/graphs.py's ``localize_graphed``.  The Jacobians are jets
(core/jet.py).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ar_slam_tpu_torch import cuda, programs
from ar_slam_tpu_torch.core import jet as J
from ar_slam_tpu_torch.core.projection import block_residual
from ar_slam_tpu_torch.core.seeding import seed_capture_pose
from ar_slam_tpu_torch.device import resolve_device, resolve_dtype
from ar_slam_tpu_torch.graph.arrays import bucket_size
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.solve.lm import LMConfig
from ar_slam_tpu_torch.utils.metrics import TRACE

logger = logging.getLogger(__name__)

launches = 0  # K5 wrapper calls since the last reset


def _query_residuals(camera, pose, tps, corners, maskf, aruco_size: float,
                     config: LMConfig):
    """(Q, K*8) residuals of every query's blocks at its pose (Q, 6),
    padded blocks zeroed; with ``pose`` a jet (core/jet.py), a jet whose
    tangents are the (Q, K*8, 6) Jacobians."""
    r = block_residual(camera, pose[:, None, :], tps, corners, aruco_size,
                       config.enable_distortion)  # (Q, K, 8)
    r = J.where(maskf[..., None] > 0, r,
                torch.zeros((), dtype=camera.dtype, device=camera.device))
    return r.reshape((r.shape[0], -1))


def localize_init(camera, tag_poses, q_tag_idx, q_corners, q_block_mask,
                  q_seed_slot, *, aruco_size: float, config: LMConfig,
                  seed_mode: str = "hybrid") -> dict:
    """The loop's start: each query's seed pose and cost, its damping and
    its flags.  Returns the loop's tensors: tps (Q, K, 6) the blocks' tag
    poses, maskf, pose, lam, nu, cost, it, conv."""
    dtype = camera.dtype
    q = q_tag_idx.shape[0]
    ar = torch.arange(q, device=camera.device)
    tps = tag_poses[q_tag_idx]  # (Q, K, 6)
    maskf = q_block_mask.to(dtype)
    seed = q_seed_slot.to(torch.int64)
    pose = seed_capture_pose(q_corners[ar, seed], camera, tps[ar, seed],
                             aruco_size, mode=seed_mode)
    lam = torch.full((q,), config.initial_lambda, dtype=dtype,
                     device=camera.device)
    r = _query_residuals(camera, pose, tps, q_corners, maskf, aruco_size,
                         config)
    return dict(
        tps=tps, maskf=maskf, pose=pose, lam=lam, nu=torch.full_like(lam, 2.0),
        cost=0.5 * torch.sum(r * r, dim=1),
        it=torch.zeros(q, dtype=torch.int64, device=camera.device),
        # queries without blocks start converged (zero residuals never
        # accept)
        conv=~q_block_mask.any(dim=1))


def localize_iteration(camera, q_corners, tps, maskf, pose, lam, nu, cost,
                       it, conv, *, aruco_size: float,
                       config: LMConfig) -> dict:
    """One LM iteration of every query still active, with no host read:
    the new (pose, lam, nu, cost, it, conv)."""
    active = ~conv
    rj = _query_residuals(camera, J.variables(pose, 6), tps, q_corners,
                          maskf, aruco_size, config)
    j, r = rj.d, rj.v  # (Q, K8, 6), (Q, K8)
    h = j.transpose(1, 2) @ j
    g = (j.transpose(1, 2) @ r[..., None])[..., 0]
    d = torch.clamp(torch.diagonal(h, dim1=1, dim2=2), 1e-6, 1e32)
    step = -torch.linalg.solve_ex(
        h + lam[:, None, None] * torch.diag_embed(d),
        g[..., None]).result[..., 0]
    new_pose = pose + step
    r_new = _query_residuals(camera, new_pose, tps, q_corners, maskf,
                             aruco_size, config)
    new_cost = 0.5 * torch.sum(r_new * r_new, dim=1)
    js = (j @ step[..., None])[..., 0]
    model = -(g * step).sum(1) - 0.5 * torch.sum(js * js, dim=1)
    rho = (cost - new_cost) / torch.clamp(model, min=1e-30)
    accept = rho > config.min_relative_decrease
    lam_acc = torch.clamp(
        lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
        config.min_lambda, config.max_lambda)
    lam_rej = torch.clamp(lam * nu, max=config.max_lambda)
    # the reference's three-way exit: function or parameter tolerance
    # on an accepted step, stall-lambda on a rejected one
    f_conv = torch.abs(cost - new_cost) <= config.function_tolerance * cost
    step_norm = torch.sqrt(torch.sum(step * step, dim=1))
    x_norm = torch.sqrt(torch.sum(pose * pose, dim=1))
    p_conv = step_norm <= config.parameter_tolerance * (
        x_norm + config.parameter_tolerance)
    stalled = ~accept & (lam >= config.stall_lambda)
    new_conv = (accept & (f_conv | p_conv)) | stalled
    take = active & accept
    return dict(
        pose=torch.where(take[:, None], new_pose, pose),
        cost=torch.where(take, new_cost, cost),
        lam=torch.where(active, torch.where(accept, lam_acc, lam_rej), lam),
        nu=torch.where(active, torch.where(accept, torch.full_like(nu, 2.0),
                                           nu * 2.0), nu),
        it=it + active.to(torch.int64),
        conv=torch.where(active, new_conv, conv))


def localize_lm(camera, q_corners, s: dict, *, aruco_size: float,
                config: LMConfig) -> dict:
    """K5 (csrc/localize.cu): the whole LM of every query in one launch on
    the card, from ``localize_init``'s state ``s``, whose pose, lam, nu,
    cost, it and conv it updates in place and returns.  The same
    iterations and stopping tests as ``localize_iteration`` stepped until
    every query has converged or reached ``max_iterations``, its plain
    twin (``graphs.localize_graphed`` off the card)."""
    global launches
    dtype = camera.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"camera must be float32 or float64, got {dtype}")
    q, k = s["maskf"].shape
    args = ((camera, "camera", dtype, (3,)),
            (q_corners, "q_corners", dtype, (q, k, 4, 2)),
            (s["tps"], "tps", dtype, (q, k, 6)),
            (s["maskf"], "maskf", dtype, (q, k)),
            (s["pose"], "pose", dtype, (q, 6)),
            *((s[n], n, dtype, (q,)) for n in ("lam", "nu", "cost")),
            (s["it"], "it", torch.int64, (q,)),
            (s["conv"], "conv", torch.bool, (q,)))
    for t, name, dt, shape in args:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for t, name, _, _ in args:
        if not t.is_cuda or t.device != camera.device:
            raise ValueError(f"{name} must be a CUDA tensor on the camera's "
                             f"device, not {t.device}")
    cuda.check(cuda.library().arslam_localize_lm(
        camera.data_ptr(), q_corners.data_ptr(), s["tps"].data_ptr(),
        s["maskf"].data_ptr(), *(s[n].data_ptr() for n in (
            "pose", "lam", "nu", "cost", "it", "conv")),
        q, k, int(dtype == torch.float64), int(config.enable_distortion),
        float(aruco_size), config.max_iterations,
        config.min_relative_decrease, config.function_tolerance,
        config.parameter_tolerance, config.min_lambda, config.max_lambda,
        config.stall_lambda, cuda.stream()), "arslam_localize_lm")
    launches += 1
    return s


def localize_many(store: MapStore, first_loc_cap_idx: int, config=None,
                  dtype=None, device=None, graphs: bool = True) -> dict:
    """Localize every capture with index >= first_loc_cap_idx against the
    frozen map built from earlier captures, on ``device`` (default: the
    card) in ``dtype`` (default: config.solver.dtype), through the stages
    of ``graphs.localize_graphed``: on the card one stage (the seeds and
    K5), a replayed CUDA graph where ``programs.graphed`` allows, else run
    eagerly; elsewhere the seeds and the host's loop over the iteration.

    Mutates the query captures' poses in the store.  Returns a summary with
    per-capture status ("localized" / "disconnected").
    """
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.solve import graphs as solve_graphs
    from ar_slam_tpu_torch.solve.batch import _lm_config

    config = config or ArSlamConfig()
    device = resolve_device(device)
    dtype = resolve_dtype(dtype if dtype is not None else config.solver.dtype)

    def tag_in_map(tag) -> bool:
        return any(store.blocks[tbh].cap_idx < first_loc_cap_idx
                   for tbh in tag.blocks)

    # parity switch: the reference's localizeOne adds ALL of the query's
    # blocks with tag poses constant, including tags absent from the map
    # (ar_slam_util.cpp:950-972); the default uses only map-known tags
    include_unknown = bool(getattr(config.solver, "localize_unknown_tags",
                                   False))
    with TRACE.span("localize.gather"):
        queries = []
        status = {}
        for cap in store.captures[first_loc_cap_idx:]:
            # the seed block must be map-known either way (≙ the
            # initCapturePose source block, ar_slam_util.cpp:911-927)
            seed_block = None
            map_blocks = []
            for bh in cap.blocks:
                tag = store.arucos[store.blocks[bh].tag_idx]
                if tag_in_map(tag):
                    map_blocks.append(bh)
                    if seed_block is None:
                        seed_block = bh
                elif include_unknown:
                    map_blocks.append(bh)
            if seed_block is None:
                logger.warning("Cannot find connected ar tags for capture %d",
                               cap.index)
                status[cap.uid] = "disconnected"
                continue
            queries.append((cap, seed_block, map_blocks))
            status[cap.uid] = "localized"

        if not queries:
            return {"status": status, "localized": 0}

        # the shapes are bucketed as the JAX package buckets them, so that a
        # few programs serve every call: padded blocks are masked to exact
        # zeros, padded queries (all-false masks) start converged and are
        # dropped, padded tag rows are never gathered
        q = len(queries)
        k_pad = bucket_size(max(len(mb) for _, _, mb in queries), floor=4)
        q_pad = bucket_size(q, floor=4)
        q_tag_idx = np.zeros((q_pad, k_pad), dtype=np.int64)
        q_corners = np.zeros((q_pad, k_pad, 4, 2), dtype=np.float64)
        q_mask = np.zeros((q_pad, k_pad), dtype=bool)
        q_seed = np.zeros(q_pad, dtype=np.int64)
        for qi, (cap, seed_block, map_blocks) in enumerate(queries):
            for ki, bh in enumerate(map_blocks):
                block = store.blocks[bh]
                q_tag_idx[qi, ki] = block.tag_idx
                q_corners[qi, ki] = block.corners
                q_mask[qi, ki] = True
                if bh == seed_block:
                    q_seed[qi] = ki
        tag_poses = np.zeros((bucket_size(max(len(store.arucos), 1)), 6))
        for tag in store.arucos:
            tag_poses[tag.index] = tag.pose

    def dev(a, dt=None):  # a blocking copy to the card
        return TRACE.wait("localize.upload", torch.as_tensor, a,
                          device=device, dtype=dt)

    poses, costs, iters = solve_graphs.localize_graphed(
        dev(store.camera.params, dtype), dev(tag_poses, dtype),
        dev(q_tag_idx), dev(q_corners, dtype), dev(q_mask), dev(q_seed),
        aruco_size=config.aruco_size,
        config=_lm_config(config.solver, config.camera),
        seed_mode=config.solver.seed_mode,
        graphed=programs.graphed(device, graphs))
    poses, costs, iters = (TRACE.wait("localize.out", x.cpu).numpy()[:q]
                           for x in (poses, costs, iters))
    # the iterations of the call's longest query: the replays a host-stepped
    # loop would have run
    TRACE.count("localize.iterations", int(iters.max()))
    with TRACE.span("localize.writeback"):
        for qi, (cap, _, _) in enumerate(queries):
            cap.inv_pose[:] = poses[qi]
        n_blocks = int(q_mask.sum())
        return {
            "status": status,
            "localized": len(queries),
            "cost": float(costs.sum()),
            "rmse": float(np.sqrt(2.0 * costs.sum() / (8 * n_blocks))),
            "iterations": {cap.uid: int(iters[qi])
                           for qi, (cap, _, _) in enumerate(queries)},
        }
