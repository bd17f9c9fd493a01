"""Levenberg–Marquardt trust-region driver, grouped dense-Schur branch
(port of ar_slam_tpu/solve/lm.py).

The loop runs in Python with its state on the device; each iteration reads
back two flags (accept / converged).  The accept/reject rule, the lambda
schedule and the three termination tests are ``lm_core``'s exactly:
accept when rho = actual / model decrease > min_relative_decrease; on
accept lam *= max(1/3, 1 - (2 rho - 1)^3) and nu = 2, on reject lam *= nu
and nu doubles; stop on the function, parameter or gradient tolerance, or
when every step is rejected past ``stall_lambda``.

The assembled normal equations are carried between iterations and rebuilt
only after an accepted step; step quality comes from quad forms on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ar_slam_tpu_torch.solve.residuals import linearize, residuals_and_rho
from ar_slam_tpu_torch.solve.schur import (assemble_grouped,
                                           group_blocks_by_tag,
                                           quad_form_grouped,
                                           schur_solve_grouped)


class LMConfig(NamedTuple):
    max_iterations: int = 50
    initial_lambda: float = 1e-4
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    jacobi_scaling: bool = True
    max_lambda: float = 1e32
    min_lambda: float = 1e-16
    stall_lambda: float = 1e12
    enable_distortion: bool = False
    linear_solver: str = "dense"  # only "dense" is ported
    loss: str = "trivial"
    loss_scale: float = 4.0


class LMState(NamedTuple):
    camera: torch.Tensor  # (3,)
    cap_poses: torch.Tensor  # (C, 6)
    tag_poses: torch.Tensor  # (T, 6)
    lam: torch.Tensor  # ()
    nu: torch.Tensor  # ()
    cost: torch.Tensor  # ()
    iteration: int
    converged: torch.Tensor  # () bool
    term: torch.Tensor  # () int32 termination code (TERMINATION_REASONS)


TERMINATION_REASONS = {
    0: "NO_CONVERGENCE",
    1: "FUNCTION_TOLERANCE",
    2: "PARAMETER_TOLERANCE",
    3: "GRADIENT_TOLERANCE",
    4: "TRUST_REGION_STALL",
    5: "DISABLED",
}


def _grad_inf_norm(eqs, cam_active, cap_active, tag_active):
    """||J^T r||_inf over the ACTIVE parameters (ceres' gradient test)."""
    dt = eqs.g_p.dtype
    cam = torch.as_tensor(cam_active, device=eqs.g_c.device)
    gc = torch.where(cam, torch.max(torch.abs(eqs.g_c)),
                     torch.zeros((), dtype=dt, device=eqs.g_c.device))
    gp = torch.max(torch.abs(eqs.g_p) * cap_active[:, None].to(dt))
    gt = torch.max(torch.abs(eqs.g_t) * tag_active[:, None].to(dt))
    return torch.maximum(gc, torch.maximum(gp, gt))


def make_grouped_hooks(cap_idx, tag_idx, corners, block_mask, aruco_size,
                       n_caps, n_tags, s_max, sc_max, distortion=False,
                       loss="trivial", loss_scale=1.0):
    """Hooks over a TAG-GROUPED (T*S) block table, regrouped once here (by
    tag, and by capture for the capture-side sums).

    Returns (lin_fn, quality_fn, slot_cap) with slot_cap the grouped
    capture index of every slot."""
    dev = cap_idx.device
    gather, mask_g = group_blocks_by_tag(tag_idx, block_mask, n_tags, s_max)
    tag_idx_g = torch.arange(n_tags, device=dev).repeat_interleave(s_max)
    cap_idx_g = cap_idx.to(torch.int64)[gather]
    cap_gather, cap_gmask = group_blocks_by_tag(cap_idx_g, mask_g, n_caps,
                                                sc_max)
    corners_g = corners[gather]

    def lin_fn(camera, cap_poses, tag_poses):
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tag_poses, cap_idx_g, tag_idx_g, corners_g,
            mask_g, aruco_size, distortion, loss, loss_scale)
        eqs = assemble_grouped(r, jc, jp, jt, cap_gather, cap_gmask, n_caps,
                               n_tags, s_max)
        return eqs, 0.5 * torch.sum(rho)

    def quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag):
        _, rho_new = residuals_and_rho(
            new_camera, new_caps, new_tags, cap_idx_g, tag_idx_g, corners_g,
            mask_g, aruco_size, distortion, loss, loss_scale)
        g_dot_d, jd_sq = quad_form_grouped(eqs, cap_idx_g, d_cam, d_cap,
                                           d_tag)
        return 0.5 * torch.sum(rho_new), g_dot_d, jd_sq

    return lin_fn, quality_fn, cap_idx_g


def lm_core(camera, cap_poses, tag_poses, cam_active, cap_active, tag_active,
            lin_fn, quality_fn, solve_fn, config: LMConfig, enabled=True,
            iter_budget=None):
    """Generic LM loop over the hooks; ``solve_fn(eqs, lam) -> (d_cam,
    d_cap, d_tag)``.  ``enabled=False`` runs zero iterations (seed-only
    waves).  Returns (camera, cap_poses, tag_poses, info)."""
    dtype = cap_poses.dtype
    dev = cap_poses.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    eqs, cost0 = lin_fn(camera, cap_poses, tag_poses)
    g_conv0 = _grad_inf_norm(eqs, cam_active, cap_active, tag_active) <= (
        config.gradient_tolerance)
    enabled = bool(enabled)
    converged = g_conv0 | (not enabled)
    term = torch.where(g_conv0, 3, 0) if enabled else torch.tensor(5)
    state = LMState(
        camera=camera.to(dtype), cap_poses=cap_poses, tag_poses=tag_poses,
        lam=scalar(config.initial_lambda), nu=scalar(2.0), cost=cost0,
        iteration=0,
        converged=converged, term=torch.as_tensor(term, device=dev))

    budget = min(config.max_iterations if iter_budget is None
                 else int(iter_budget), config.max_iterations)
    while state.iteration < budget and not bool(state.converged):
        d_cam, d_cap, d_tag = solve_fn(eqs, state.lam)
        new_camera = state.camera + d_cam
        new_caps = state.cap_poses + d_cap
        new_tags = state.tag_poses + d_tag
        new_cost, g_dot_d, jd_sq = quality_fn(
            eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag)

        model_decrease = torch.clamp(-g_dot_d - 0.5 * jd_sq, min=1e-30)
        rho = (state.cost - new_cost) / model_decrease
        accept = rho > config.min_relative_decrease
        lam_acc = state.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                          min=1.0 / 3.0)
        lam_acc = torch.clamp(lam_acc, config.min_lambda, config.max_lambda)
        lam_rej = torch.clamp(state.lam * state.nu, max=config.max_lambda)

        f_conv = (torch.abs(state.cost - new_cost)
                  <= config.function_tolerance * state.cost)
        step_norm = torch.sqrt(torch.sum(d_cam ** 2) + torch.sum(d_cap ** 2)
                               + torch.sum(d_tag ** 2))
        x_norm = torch.sqrt(torch.sum(state.camera ** 2)
                            + torch.sum(state.cap_poses ** 2)
                            + torch.sum(state.tag_poses ** 2))
        p_conv = step_norm <= config.parameter_tolerance * (
            x_norm + config.parameter_tolerance)
        stalled = ~accept & (state.lam >= config.stall_lambda)
        converged_fp = (accept & (f_conv | p_conv)) | stalled

        accepted, done_fp = torch.stack([accept, converged_fp]).tolist()
        g_conv = torch.zeros((), dtype=torch.bool, device=dev)
        if accepted and not done_fp:  # relinearize only when it is needed
            eqs, _ = lin_fn(new_camera, new_caps, new_tags)
            g_conv = _grad_inf_norm(eqs, cam_active, cap_active,
                                    tag_active) <= config.gradient_tolerance
        term = torch.where(
            stalled, 4, torch.where(g_conv, 3, torch.where(
                accept & f_conv, 1, torch.where(accept & p_conv, 2, 0))))
        state = LMState(
            camera=torch.where(accept, new_camera, state.camera),
            cap_poses=torch.where(accept, new_caps, state.cap_poses),
            tag_poses=torch.where(accept, new_tags, state.tag_poses),
            lam=torch.where(accept, lam_acc, lam_rej),
            nu=torch.where(accept, scalar(2.0), state.nu * 2.0),
            cost=torch.where(accept, new_cost, state.cost),
            iteration=state.iteration + 1,
            converged=converged_fp | g_conv,
            term=term,
        )
    info = {
        "cost": state.cost,
        "iterations": state.iteration,
        "lambda": state.lam,
        "converged": state.converged,
        "initial_cost": cost0,
        "termination": state.term,
        "nu": state.nu,
        "grad_max": _grad_inf_norm(eqs, cam_active, cap_active, tag_active),
    }
    return state.camera, state.cap_poses, state.tag_poses, info


def obs_bound(idx: torch.Tensor, mask: torch.Tensor, n: int) -> int:
    """Most observations of any index (a host read), bucketed like
    graph.arrays.obs_bucket: multiples of 8."""
    counts = torch.bincount(idx[mask].to(torch.int64), minlength=n)
    m = max(int(counts.max().item()) if counts.numel() else 1, 1)
    return -(-m // 8) * 8


def lm_solve(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
             block_mask, cam_active, cap_active, tag_active, *,
             aruco_size: float, config: LMConfig = LMConfig(), enabled=True,
             iter_budget=None, obs_per_tag: int | None = None,
             obs_per_cap: int | None = None):
    """Run LM on the (masked, padded) problem on the tensors' device.

    ``obs_per_tag``/``obs_per_cap`` are static upper bounds on the
    observations per tag / capture (excess observations would be dropped);
    when omitted they are read off the block table.  This is the
    reference's grouped (tag-grouped, dense Schur) branch; its flat and CG
    branches are not ported.
    """
    if config.linear_solver != "dense":
        raise NotImplementedError(
            f"linear_solver={config.linear_solver!r}: only the dense "
            "grouped Schur solver is ported")
    n_caps = cap_poses.shape[0]
    n_tags = tag_poses.shape[0]
    if obs_per_tag is None:
        obs_per_tag = obs_bound(tag_idx, block_mask, n_tags)
    if obs_per_cap is None:
        obs_per_cap = obs_bound(cap_idx, block_mask, n_caps)
    lin_fn, quality_fn, slot_cap = make_grouped_hooks(
        cap_idx, tag_idx, corners, block_mask, aruco_size, n_caps, n_tags,
        obs_per_tag, obs_per_cap, distortion=config.enable_distortion,
        loss=config.loss, loss_scale=config.loss_scale)

    def solve_fn(eqs, lam):
        return schur_solve_grouped(eqs, slot_cap, lam, cam_active,
                                   cap_active, tag_active,
                                   jacobi_scaling=config.jacobi_scaling)

    return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                   tag_active, lin_fn, quality_fn, solve_fn, config,
                   enabled=enabled, iter_budget=iter_budget)
