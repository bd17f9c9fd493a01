"""Levenberg–Marquardt trust-region loop (port of ar_slam_tpu/solve/lm.py).

The loop runs in Python with its state on the device.  ``lm_init``,
``lm_step``, ``lm_accept`` and ``lm_reject`` are its start and the parts
of its body, none with a host read; solve/graphs.py runs them as the
stages of a program (``programs.Program``) driven by one host loop with
one read an iteration (the counterpart of the reference's
``lax.while_loop``): replayed as CUDA graphs on the card, the same stages
run eagerly on the CPU and with ``graphs=False``.  The accept/reject
rule, the lambda schedule and the three termination tests are the
reference's ``lm_core``'s exactly:
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

from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.solve.residuals import linearize, residuals_and_rho
from ar_slam_tpu_torch.solve.schur import (assemble, assemble_grouped,
                                           flat_plans, group_blocks_by_tag,
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
    """||J^T r||_inf over the ACTIVE parameters (ceres' gradient test).
    Takes the field-named eqs, or the distributed hooks' ``ShardedEqs``,
    whose tag part the hooks reduced already (``g_t_max``)."""
    gt = getattr(eqs, "g_t_max", None)
    cap = eqs if gt is None else eqs.cap
    dt = cap.g_p.dtype
    gc = torch.where(cam_active.to(cap.g_c.device),
                     torch.max(torch.abs(cap.g_c)),
                     torch.zeros((), dtype=dt, device=cap.g_c.device))
    gp = torch.max(torch.abs(cap.g_p) * cap_active[:, None].to(dt))
    if gt is None:
        gt = torch.max(torch.abs(eqs.g_t) * tag_active[:, None].to(dt))
    return torch.maximum(gc, torch.maximum(gp, gt))


def make_block_hooks(cap_idx, tag_idx, corners, block_mask, aruco_size,
                     n_caps, n_tags, distortion=False, loss="trivial",
                     loss_scale=1.0):
    """Hooks over the flat (padded) block table: (lin_fn, quality_fn).
    The assembly's fixed-order sums (``schur.flat_plans``) are planned
    once here."""
    plans = flat_plans(cap_idx, tag_idx, n_caps, n_tags, block_mask)

    def lin_fn(camera, cap_poses, tag_poses):
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
            block_mask, aruco_size, distortion, loss, loss_scale)
        eqs = assemble(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags,
                       plans=plans)
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


def lm_init(camera, cap_poses, tag_poses, cam_active, cap_active, tag_active,
            lin_fn, config: LMConfig):
    """The loop's start: the first linearization, the gradient test and
    the initial state.  Returns (state, eqs).  Every scalar is a fill on
    the tensors' device, none a host-to-device copy."""
    dtype = cap_poses.dtype
    dev = cap_poses.device
    eqs, cost0 = lin_fn(camera, cap_poses, tag_poses)
    g_conv0 = _grad_inf_norm(eqs, cam_active, cap_active, tag_active) <= (
        config.gradient_tolerance)
    state = LMState(
        camera=camera.to(dtype), cap_poses=cap_poses, tag_poses=tag_poses,
        lam=torch.full((), config.initial_lambda, dtype=dtype, device=dev),
        nu=torch.full((), 2.0, dtype=dtype, device=dev),
        cost=cost0, iteration=0, converged=g_conv0,
        term=torch.where(g_conv0, 3, 0))
    return state, eqs


def _decide(state: LMState, new_cost, g_dot_d, jd_sq, d_cam, d_cap,
            tag_step_sq, tag_x_sq, config: LMConfig):
    """The step's quality and tests: (accept, lam_acc, lam_rej, f_conv,
    p_conv, stalled, converged_fp)."""
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
                           + tag_step_sq)
    x_norm = torch.sqrt(torch.sum(state.camera ** 2)
                        + torch.sum(state.cap_poses ** 2) + tag_x_sq)
    p_conv = step_norm <= config.parameter_tolerance * (
        x_norm + config.parameter_tolerance)
    stalled = ~accept & (state.lam >= config.stall_lambda)
    converged_fp = (accept & (f_conv | p_conv)) | stalled
    return accept, lam_acc, lam_rej, f_conv, p_conv, stalled, converged_fp


def _term(stalled, g_conv, accept, f_conv, p_conv):
    """The termination code of TERMINATION_REASONS."""
    return torch.where(
        stalled, 4, torch.where(g_conv, 3, torch.where(
            accept & f_conv, 1, torch.where(accept & p_conv, 2, 0))))


class LMStep(NamedTuple):
    """One step's proposal and decision (``lm_step``).  ``flags`` is
    [converged before the step, run ``lm_accept`` next (else
    ``lm_reject``), converged after it]: the host's one read an
    iteration, which ends the loop on the first (dropping the proposal),
    runs the stage the second names, then ends the loop on the third.
    Over a fused ``quality_lin_fn`` the step carries the speculative
    relinearization ``eqs`` and its gradient test ``g_conv``, so the third
    flag is the state's next ``converged``; else it is ``converged_fp``
    and the gradient test shows in the next step's first flag."""

    camera: torch.Tensor
    cap_poses: torch.Tensor
    tag_poses: torch.Tensor
    cost: torch.Tensor
    lam_acc: torch.Tensor
    lam_rej: torch.Tensor
    accept: torch.Tensor
    f_conv: torch.Tensor
    p_conv: torch.Tensor
    stalled: torch.Tensor
    converged_fp: torch.Tensor
    sol: torch.Tensor | None  # the CG solve's reduced solution
    flags: torch.Tensor  # (3,) bool
    eqs: object = None  # fused: the speculative relinearization
    g_conv: torch.Tensor | None = None  # fused: its gradient test


def lm_step(state: LMState, eqs, sol, solve_fn, quality_fn,
            config: LMConfig, quality_lin_fn=None, active=None) -> LMStep:
    """The damped solve, the proposal, its quality and the tests of one
    iteration, with no host read.

    ``solve_fn(eqs, lam) -> (d_cam, d_cap, d_tag)`` is the damped solve;
    with ``sol`` (the CG warm start; None for a stateless solve) it is
    ``solve_fn(eqs, lam, sol) -> (d_cam, d_cap, d_tag, sol)``, the reduced
    solution threaded through as the next warm start (zeroed after an
    accepted step: the next optimal step is near zero).

    ``quality_lin_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap,
    d_tag) -> (new_cost, g_dot_d, jd_sq, eqs_new)`` replaces quality_fn
    and the accept stage's relinearization: it relinearizes speculatively
    at the proposal, so the tag-sharded hooks pack the step quality and
    the new capture-side blocks into one reduction (two reductions an
    iteration: the solve's and this one); an accepted step keeps
    ``eqs_new``, a rejected one drops it.  Its eqs carry the tag-side sums
    the loop needs, reduced in the same packs: ``tag_sq`` (sum of the
    squared tag poses they were linearized at), ``step_sq`` (sum of the
    squared tag step that proposed them) and ``g_t_max``
    (``_grad_inf_norm``).  The step then also makes the gradient test on
    the speculative relinearization (false unless the step is accepted
    and does not converge otherwise), over the masks ``active`` =
    (cam_active, cap_active, tag_active)."""
    if sol is None:
        d_cam, d_cap, d_tag = solve_fn(eqs, state.lam)
    else:
        d_cam, d_cap, d_tag, sol = solve_fn(eqs, state.lam, sol)
    new_camera = state.camera + d_cam
    new_caps = state.cap_poses + d_cap
    new_tags = state.tag_poses + d_tag
    if quality_lin_fn is not None:
        new_cost, g_dot_d, jd_sq, eqs_prop = quality_lin_fn(
            eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag)
        tag_step_sq, tag_x_sq = eqs_prop.step_sq, eqs.tag_sq
    else:
        new_cost, g_dot_d, jd_sq = quality_fn(
            eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag)
        tag_step_sq = torch.sum(d_tag ** 2)
        tag_x_sq = torch.sum(state.tag_poses ** 2)
    (accept, lam_acc, lam_rej, f_conv, p_conv, stalled,
     converged_fp) = _decide(state, new_cost, g_dot_d, jd_sq, d_cam, d_cap,
                             tag_step_sq, tag_x_sq, config)
    if quality_lin_fn is None:
        eqs_prop = g_conv = None
        flags = torch.stack([state.converged, accept & ~converged_fp,
                             converged_fp])
    else:
        g_conv = accept & ~converged_fp & (_grad_inf_norm(
            eqs_prop, *active) <= config.gradient_tolerance)
        flags = torch.stack([state.converged, accept,
                             converged_fp | g_conv])
    return LMStep(new_camera, new_caps, new_tags, new_cost, lam_acc, lam_rej,
                  accept, f_conv, p_conv, stalled, converged_fp, sol, flags,
                  eqs_prop, g_conv)


def _lm_update(state: LMState, step: LMStep, g_conv):
    """The state after ``step``, selected on its accept flag (shard by
    shard for ``Sharded`` tags), and the CG warm start zeroed after an
    accepted step.  Returns (state, sol)."""
    acc = step.accept

    def pick(new, old):
        if isinstance(new, list):  # parallel.mesh.Sharded
            return type(new)(torch.where(acc.to(n.device), n, o)
                             for n, o in zip(new, old))
        return torch.where(acc, new, old)

    state = LMState(
        camera=pick(step.camera, state.camera),
        cap_poses=pick(step.cap_poses, state.cap_poses),
        tag_poses=pick(step.tag_poses, state.tag_poses),
        lam=pick(step.lam_acc, step.lam_rej),
        nu=pick(torch.full_like(state.nu, 2.0), state.nu * 2.0),
        cost=pick(step.cost, state.cost),
        iteration=state.iteration + 1,
        converged=step.converged_fp | g_conv,
        term=_term(step.stalled, g_conv, acc, step.f_conv, step.p_conv))
    sol = None if step.sol is None else pick(torch.zeros_like(step.sol),
                                             step.sol)
    return state, sol


def lm_accept(state: LMState, step: LMStep, lin_fn, cam_active, cap_active,
              tag_active, config: LMConfig):
    """An accepted step: the relinearization at the proposal, the gradient
    test and the state update (a step that ends the loop takes
    ``lm_reject`` instead); a fused step's (``step.eqs``) speculative eqs
    and test adopted in their place, also when it ends the loop.  Returns
    (state, eqs, sol)."""
    if step.eqs is not None:
        state, sol = _lm_update(state, step, step.g_conv)
        return state, step.eqs, sol
    eqs, _ = lin_fn(step.camera, step.cap_poses, step.tag_poses)
    g_conv = _grad_inf_norm(eqs, cam_active, cap_active,
                            tag_active) <= config.gradient_tolerance
    state, sol = _lm_update(state, step, g_conv)
    return state, eqs, sol


def lm_reject(state: LMState, step: LMStep):
    """A rejected step, or an accepted one that ends the loop (neither
    relinearizes): the state update.  Returns (state, sol)."""
    g_conv = torch.zeros((), dtype=torch.bool, device=step.accept.device)
    return _lm_update(state, step, g_conv)


def grouped_bounds(n_tags: int, config: LMConfig, obs_per_tag: int,
                   obs_per_cap: int | None = None,
                   row_slots: int | None = None, tag_rows: int | None = None,
                   cap_rows: int | None = None) -> dict:
    """The grouped hooks' static slot bounds as ``lm_solve`` takes them:
    ``obs_per_cap`` defaults to n_tags * obs_per_tag (safe but wasteful);
    the dense solve drops the row-split budgets."""
    if obs_per_cap is None:
        obs_per_cap = n_tags * obs_per_tag
    if config.linear_solver != "cg":
        # the dense grouped elimination consumes the (T, S_max) form
        row_slots = tag_rows = cap_rows = None
    return dict(obs_per_tag=obs_per_tag, obs_per_cap=obs_per_cap,
                row_slots=row_slots, tag_rows=tag_rows, cap_rows=cap_rows)


def grouped_solver(cap_idx, tag_idx, corners, block_mask, cam_active,
                   cap_active, tag_active, *, aruco_size: float,
                   config: LMConfig, n_caps: int, n_tags: int,
                   obs_per_tag: int, obs_per_cap: int, row_slots=None,
                   tag_rows=None, cap_rows=None):
    """The tag-grouped hooks and their damped solve (bounds from
    ``grouped_bounds``): (lin_fn, quality_fn, solve_fn, sol0) with sol0
    the CG warm start (None for the dense solve)."""
    lin_fn, quality_fn, group_ctx = make_grouped_hooks(
        cap_idx, tag_idx, corners, block_mask, aruco_size, n_caps,
        n_tags, obs_per_tag, obs_per_cap,
        distortion=config.enable_distortion, loss=config.loss,
        loss_scale=config.loss_scale, row_slots=row_slots,
        n_rows=tag_rows, n_cap_rows=cap_rows)
    slot_cap, cap_gather, cap_gmask, rows, cap_rows_ctx = group_ctx

    if config.linear_solver != "cg":
        def solve_fn(eqs, lam):
            return schur_solve_grouped(
                eqs, slot_cap, lam, cam_active, cap_active, tag_active,
                jacobi_scaling=config.jacobi_scaling)

        return lin_fn, quality_fn, solve_fn, None

    def solve_fn(eqs, lam, x0):  # noqa: F811
        return schur_solve_grouped_cg(
            eqs, slot_cap, cap_gather, cap_gmask, lam, cam_active,
            cap_active, tag_active, jacobi_scaling=config.jacobi_scaling,
            cg_tol=config.cg_tolerance, cg_iters=config.cg_max_iterations,
            x0=x0, rows=rows, cap_rows=cap_rows_ctx)

    sol0 = torch.zeros(3 + 6 * n_caps, dtype=corners.dtype,
                       device=corners.device)
    return lin_fn, quality_fn, solve_fn, sol0


def flat_solver(cap_idx, tag_idx, corners, block_mask, cam_active,
                cap_active, tag_active, *, aruco_size: float,
                config: LMConfig, n_caps: int, n_tags: int,
                assemble_fn=None):
    """The flat block hooks and the flat dense Schur solve: (lin_fn,
    quality_fn, solve_fn, None).  ``assemble_fn(r, jc, jp, jt, cap_idx,
    tag_idx, n_caps, n_tags) -> NormalEqs`` replaces the assembly; inside
    a CUDA graph's capture it must not read the host (as JAX's jit
    requires it to trace), and an error it raises there names it."""
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
            try:
                eqs = assemble_fn(r, jc, jp, jt, cap_idx, tag_idx, n_caps,
                                  n_tags)
            except RuntimeError as e:
                if r.is_cuda and torch.cuda.is_current_stream_capturing():
                    name = getattr(assemble_fn, "__qualname__", assemble_fn)
                    raise RuntimeError(
                        f"assemble_fn {name!r} cannot be captured into a "
                        "CUDA graph: it reads the host or synchronises the "
                        "card (graphs=False runs it eagerly)") from e
                raise
            return eqs, 0.5 * torch.sum(rho)

    def solve_fn(eqs, lam):
        return schur_solve(eqs, lam, cam_active, cap_active, tag_active,
                           jacobi_scaling=config.jacobi_scaling)

    return lin_fn, quality_fn, solve_fn, None


def lm_solve(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
             block_mask, cam_active, cap_active, tag_active, *,
             aruco_size: float, config: LMConfig = LMConfig(),
             assemble_fn=None, enabled=True, iter_budget=None,
             obs_per_tag: int | None = None, obs_per_cap: int | None = None,
             row_slots: int | None = None, tag_rows: int | None = None,
             cap_rows: int | None = None, lam0=None, nu0=None,
             graphs: bool = True):
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
    flat block hooks and the flat dense Schur solve run (``flat_solver``).
    ``lam0`` / ``nu0`` resume the damping schedule (host-stepped progress
    printing); ``enabled=False`` runs zero iterations (seed-only waves).

    Either LM runs as the stages of solve/graphs.py (``lm_solve_graphed``):
    replayed CUDA graphs where ``programs.graphed`` allows, else the same
    stages eagerly.
    """
    from ar_slam_tpu_torch.solve.graphs import lm_solve_graphed

    bounds = {} if obs_per_tag is None or assemble_fn is not None else (
        grouped_bounds(tag_poses.shape[0], config, obs_per_tag, obs_per_cap,
                       row_slots, tag_rows, cap_rows))
    return lm_solve_graphed(
        camera, cap_poses, tag_poses, cap_idx, tag_idx, corners, block_mask,
        cam_active, cap_active, tag_active, aruco_size=aruco_size,
        config=config, enabled=enabled, iter_budget=iter_budget, lam0=lam0,
        nu0=nu0, assemble_fn=assemble_fn,
        graphed=programs.graphed(cap_poses.device, graphs), **bounds)
