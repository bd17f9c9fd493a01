"""Levenberg–Marquardt trust-region loop (port of ar_slam_tpu/solve/lm.py).

The loop runs in Python with its state on the device; each iteration reads
back two flags (accept / converged).  The accept/reject rule, the lambda
schedule and the three termination tests are ``lm_core``'s exactly:
accept when rho = actual / model decrease > min_relative_decrease; on
accept lam *= max(1/3, 1 - (2 rho - 1)^3) and nu = 2, on reject lam *= nu
and nu doubles; stop on the function, parameter or gradient tolerance, or
when every step is rejected past ``stall_lambda``.

The assembled normal equations are carried between iterations and rebuilt
only after an accepted step; step quality comes from quad forms on them.
``lm_solve`` runs the tag-grouped hooks when given ``obs_per_tag`` (with
the dense Schur solve, or implicit-Schur CG for ``linear_solver="cg"``)
and the flat block hooks otherwise, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ar_slam_tpu_torch.solve.residuals import linearize, residuals_and_rho
from ar_slam_tpu_torch.solve.schur import (assemble, assemble_grouped,
                                           group_blocks_by_tag,
                                           group_blocks_by_tag_rows,
                                           quad_form_flat, quad_form_grouped,
                                           schur_solve, schur_solve_grouped,
                                           schur_solve_grouped_cg)


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
    # "dense" = Cholesky on the reduced system (≙ DENSE_SCHUR); "cg" =
    # implicit-Schur preconditioned CG (≙ ITERATIVE_SCHUR).  Grouped path.
    linear_solver: str = "dense"
    # CG's relative tolerance and step cap: the trust region absorbs the
    # inexact steps (the reference's defaults)
    cg_tolerance: float = 0.3
    cg_max_iterations: int = 25
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


def make_block_hooks(cap_idx, tag_idx, corners, block_mask, aruco_size,
                     n_caps, n_tags, distortion=False, loss="trivial",
                     loss_scale=1.0):
    """Hooks over the flat (padded) block table: (lin_fn, quality_fn)."""

    def lin_fn(camera, cap_poses, tag_poses):
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
            block_mask, aruco_size, distortion, loss, loss_scale)
        eqs = assemble(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags)
        return eqs, 0.5 * torch.sum(rho)

    def quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag):
        _, rho_new = residuals_and_rho(
            new_camera, new_caps, new_tags, cap_idx, tag_idx, corners,
            block_mask, aruco_size, distortion, loss, loss_scale)
        g_dot_d, jd_sq = quad_form_flat(eqs, d_cam, d_cap, d_tag)
        return 0.5 * torch.sum(rho_new), g_dot_d, jd_sq

    return lin_fn, quality_fn


def make_grouped_hooks(cap_idx, tag_idx, corners, block_mask, aruco_size,
                       n_caps, n_tags, s_max, sc_max, distortion=False,
                       loss="trivial", loss_scale=1.0, row_slots=None,
                       n_rows=None, n_cap_rows=None):
    """Hooks over a TAG-GROUPED (T*S) block table, regrouped once here (by
    tag, and by capture for the capture-side sums).

    ``row_slots``/``n_rows`` switch the tag side to the ROW-SPLIT layout
    (schur.TagRows: ``n_rows`` rows of ``row_slots`` slots, a tag spanning
    ceil(obs / row_slots) consecutive rows), and ``n_cap_rows`` the
    capture side likewise; for the CG solver, since the dense grouped
    elimination consumes the (T, S_max) form.

    Returns (lin_fn, quality_fn, group_ctx) with group_ctx = (slot_cap,
    cap_gather, cap_gmask, rows, cap_rows): slot_cap the grouped capture
    index of every slot, rows / cap_rows the TagRows or None."""
    dev = cap_idx.device
    if row_slots is not None:
        max_rows = -(-s_max // row_slots)
        gather, mask_g, rows = group_blocks_by_tag_rows(
            tag_idx, block_mask, n_tags, row_slots, n_rows, max_rows)
        s_used = row_slots
        tag_idx_g = rows.row_tag[:, None].expand(n_rows, row_slots).reshape(-1)
    else:
        gather, mask_g = group_blocks_by_tag(tag_idx, block_mask, n_tags,
                                             s_max)
        rows = None
        s_used = s_max
        tag_idx_g = torch.arange(n_tags, device=dev)[:, None].expand(
            n_tags, s_max).reshape(-1)
    cap_idx_g = cap_idx.to(torch.int64)[gather]
    if row_slots is not None and n_cap_rows is not None:
        max_cap_rows = -(-sc_max // row_slots)
        cap_gather, cap_gmask, cap_rows = group_blocks_by_tag_rows(
            cap_idx_g, mask_g, n_caps, row_slots, n_cap_rows, max_cap_rows)
    else:
        cap_gather, cap_gmask = group_blocks_by_tag(cap_idx_g, mask_g,
                                                    n_caps, sc_max)
        cap_rows = None
    corners_g = corners[gather]

    def lin_fn(camera, cap_poses, tag_poses):
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tag_poses, cap_idx_g, tag_idx_g, corners_g,
            mask_g, aruco_size, distortion, loss, loss_scale)
        eqs = assemble_grouped(r, jc, jp, jt, cap_gather, cap_gmask, n_caps,
                               n_tags, s_used, rows=rows, cap_rows=cap_rows)
        return eqs, 0.5 * torch.sum(rho)

    def quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag):
        _, rho_new = residuals_and_rho(
            new_camera, new_caps, new_tags, cap_idx_g, tag_idx_g, corners_g,
            mask_g, aruco_size, distortion, loss, loss_scale)
        g_dot_d, jd_sq = quad_form_grouped(eqs, cap_idx_g, d_cam, d_cap,
                                           d_tag, rows=rows)
        return 0.5 * torch.sum(rho_new), g_dot_d, jd_sq

    return lin_fn, quality_fn, (cap_idx_g, cap_gather, cap_gmask, rows,
                                cap_rows)


def lm_core(camera, cap_poses, tag_poses, cam_active, cap_active, tag_active,
            lin_fn, quality_fn, config: LMConfig, enabled=True,
            solve_fn=None, iter_budget=None, solver_state0=None, lam0=None,
            nu0=None):
    """Generic LM loop over the hooks.  Returns (camera, cap_poses,
    tag_poses, info).

    ``solve_fn(eqs, lam) -> (d_cam, d_cap, d_tag)`` is the damped solve
    (default: the flat ``schur_solve``).  With ``solver_state0`` set it is
    ``solve_fn(eqs, lam, state) -> (d_cam, d_cap, d_tag, state)``: the CG
    path threads its reduced solution through as the next warm start,
    zeroed after an accepted step (the next optimal step is near zero).
    ``enabled=False`` runs zero iterations (seed-only waves); ``lam0`` /
    ``nu0`` resume the damping schedule across host-stepped calls."""
    dtype = cap_poses.dtype
    dev = cap_poses.device
    stateful = solver_state0 is not None
    sol = solver_state0
    if solve_fn is None:
        def solve_fn(eqs, lam):
            return schur_solve(eqs, lam, cam_active, cap_active, tag_active,
                               jacobi_scaling=config.jacobi_scaling)

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
        lam=scalar(config.initial_lambda if lam0 is None else lam0),
        nu=scalar(2.0 if nu0 is None else nu0), cost=cost0, iteration=0,
        converged=converged, term=torch.as_tensor(term, device=dev))

    budget = min(config.max_iterations if iter_budget is None
                 else int(iter_budget), config.max_iterations)
    while state.iteration < budget and not bool(state.converged):
        if stateful:
            d_cam, d_cap, d_tag, sol = solve_fn(eqs, state.lam, sol)
        else:
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
        if stateful and accepted:
            sol = torch.zeros_like(sol)
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


def lm_solve(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
             block_mask, cam_active, cap_active, tag_active, *,
             aruco_size: float, config: LMConfig = LMConfig(),
             assemble_fn=None, enabled=True, iter_budget=None,
             obs_per_tag: int | None = None, obs_per_cap: int | None = None,
             row_slots: int | None = None, tag_rows: int | None = None,
             cap_rows: int | None = None, lam0=None, nu0=None):
    """Run LM on the (masked, padded) problem on the tensors' device.

    With ``obs_per_tag`` (a true upper bound on the observations per tag;
    excess ones would be dropped) the TAG-GROUPED hooks run: the dense
    grouped Schur solve, or for ``config.linear_solver == "cg"`` the
    implicit-Schur CG, warm-started from the previous reduced solution.
    ``obs_per_cap`` bounds the observations per capture (default n_tags *
    obs_per_tag: safe but wasteful).  ``row_slots`` / ``tag_rows`` /
    ``cap_rows`` switch the CG solve to the row-split packing (callers
    size tag_rows >= sum_t ceil(obs_t / row_slots), cap_rows likewise);
    the dense solve ignores them.

    Without ``obs_per_tag``, or with ``assemble_fn(r, jc, jp, jt, cap_idx,
    tag_idx, n_caps, n_tags) -> NormalEqs`` overriding the assembly, the
    flat block hooks and the flat dense Schur solve run.  ``lam0`` / ``nu0``
    resume the damping schedule (host-stepped progress printing).
    """
    n_caps = cap_poses.shape[0]
    n_tags = tag_poses.shape[0]
    if obs_per_tag is not None and assemble_fn is None:
        if obs_per_cap is None:
            obs_per_cap = n_tags * obs_per_tag
        if config.linear_solver != "cg":
            # the dense grouped elimination consumes the (T, S_max) form
            row_slots = tag_rows = cap_rows = None
        lin_fn, quality_fn, group_ctx = make_grouped_hooks(
            cap_idx, tag_idx, corners, block_mask, aruco_size, n_caps,
            n_tags, obs_per_tag, obs_per_cap,
            distortion=config.enable_distortion, loss=config.loss,
            loss_scale=config.loss_scale, row_slots=row_slots,
            n_rows=tag_rows, n_cap_rows=cap_rows)
        slot_cap, cap_gather, cap_gmask, rows, cap_rows_ctx = group_ctx

        solver_state0 = None
        if config.linear_solver == "cg":
            solver_state0 = torch.zeros(3 + 6 * n_caps, dtype=cap_poses.dtype,
                                        device=cap_poses.device)

            def solve_fn(eqs, lam, x0):
                return schur_solve_grouped_cg(
                    eqs, slot_cap, cap_gather, cap_gmask, lam, cam_active,
                    cap_active, tag_active,
                    jacobi_scaling=config.jacobi_scaling,
                    cg_tol=config.cg_tolerance,
                    cg_iters=config.cg_max_iterations, x0=x0, rows=rows,
                    cap_rows=cap_rows_ctx)
        else:
            def solve_fn(eqs, lam):
                return schur_solve_grouped(
                    eqs, slot_cap, lam, cam_active, cap_active, tag_active,
                    jacobi_scaling=config.jacobi_scaling)

        return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                       tag_active, lin_fn, quality_fn, config,
                       enabled=enabled, solve_fn=solve_fn,
                       iter_budget=iter_budget, solver_state0=solver_state0,
                       lam0=lam0, nu0=nu0)
    lin_fn, quality_fn = make_block_hooks(
        cap_idx, tag_idx, corners, block_mask, aruco_size, n_caps, n_tags,
        distortion=config.enable_distortion, loss=config.loss,
        loss_scale=config.loss_scale)
    if assemble_fn is not None:
        def lin_fn(camera, cap_poses, tag_poses):  # noqa: F811
            r, jc, jp, jt, rho = linearize(
                camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                block_mask, aruco_size, config.enable_distortion,
                config.loss, config.loss_scale)
            eqs = assemble_fn(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags)
            return eqs, 0.5 * torch.sum(rho)

    return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                   tag_active, lin_fn, quality_fn, config, enabled=enabled,
                   iter_budget=iter_budget, lam0=lam0, nu0=nu0)
