"""CUDA graphs of the solver's programs: capture, cache and replay.

The port's counterpart of the JAX package's compiled solve programs: the
wave program ``solve_wave_multi`` (ar_slam_tpu/solve/batch.py:157), its
seed ``lax.scan`` and its LM ``lax.while_loop`` with the ``lax.cond``
relinearization (ar_slam_tpu/solve/lm.py:378, :424), and
``localize_kernel`` (ar_slam_tpu/solve/localize.py:32) with its seeding
and ``while_loop``.  PyTorch runs eagerly, so an LM iteration was some
980 small launches from Python; here it is at most two graph replays and
one host read, with the results of the eager loop bit for bit (the same
kernels on the same values, in the same order).

The machinery (``Program``, the cache ``CACHE``, the capture and the
replay) is ``ar_slam_tpu_torch/programs.py``, which the detector shares;
this module holds the solver's stages and re-exports what its callers
use.

- seeds (``seed_waves_graphed``): one stage ``seed``, a flush's padded
  seed tables (solve/batch.py ``seed_waves``) applied in one replay.
- LM (``lm_solve_graphed``), over the grouped hooks or the flat ones
  (``lm.flat_solver``, an ``assemble_fn`` among them, keyed by it as
  JAX's ``static_argnames`` key it): stages ``setup`` (the regroup of the
  block table or the flat sums' plans, the first linearization, the
  gradient test, the initial state),
  ``step`` (the damped solve, the proposal, its quality and the tests),
  ``accept`` (relinearize at an accepted proposal, the gradient test, the
  state update) and ``reject`` (the state update of any other step).
  The host loop (``lm_iterate``) reads the converged flag once after
  ``setup``; an iteration replays ``step``, reads its three flags
  (converged before the step, accept stage next, converged after it) in
  one copy to the host, and replays ``accept`` or ``reject``: the eager
  loop's lazy relinearization.  A step run after a convergence that only
  the gradient test shows is dropped, which leaves the state as the
  eager loop leaves it.
- localize (``localize_graphed``): stages ``init`` (each query's seed
  pose, cost and damping) and ``iterate``; a call replays ``init`` and
  then ``iterate`` once an iteration, each replay followed by one flag
  read (any query active).

- the mesh (parallel/dist_lm.py, its shards on one card or several):
  the kinds ``"mesh_lm"`` (the tag-sharded LM's stages, with the fused
  quality, through ``lm_iterate``) and ``"mesh_seed"``; a program counts
  the packed reductions its replays run on the mesh
  (``Program.counted``), and one graph a stage spans the mesh's cards.

Each kind keeps one program per card (``programs.CACHE``): a solve's
waves, its warmups and its polish share one LM capture, and ``serve``'s
per-batch solves reuse it while their bucketed shapes repeat; a call with
another static signature (dtype, padded shapes, slot bounds,
``LMConfig``, tag size, seed mode) replaces the kind's program in the
kind's memory pool.  One thread solves at a time.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch.programs import CACHE, Program, _clone  # noqa: F401
from ar_slam_tpu_torch.solve.lm import (LMConfig, LMState, _grad_inf_norm,
                                        flat_solver, grouped_solver,
                                        lm_accept, lm_init, lm_reject,
                                        lm_step)
from ar_slam_tpu_torch.solve.batch import seed_waves
from ar_slam_tpu_torch.solve.localize import localize_init, localize_iteration

_STATE = ("camera", "cap_poses", "tag_poses", "lam", "nu", "cost",
          "converged", "term")


def state_of(t: dict) -> LMState:
    """The LM state a program's tensors hold."""
    return LMState(**{k: t[k] for k in _STATE}, iteration=0)


def fields(state: LMState) -> dict:
    """An LM state as a program's entries."""
    return {k: getattr(state, k) for k in _STATE}


def lm_info(prog: "Program", iteration: int) -> dict:
    """``lm_core``'s info dict from an LM program's tensors (copies when
    graphed)."""
    t = prog.t
    return {"cost": prog.out(t["cost"]), "iterations": iteration,
            "lambda": prog.out(t["lam"]),
            "converged": prog.out(t["converged"]),
            "initial_cost": prog.out(t["cost0"]),
            "termination": prog.out(t["term"]), "nu": prog.out(t["nu"]),
            "grad_max": _grad_inf_norm(t["eqs"], t["cam_active"],
                                       t["cap_active"], t["tag_active"])}


def lm_iterate(prog: Program, config: LMConfig, iter_budget=None) -> int:
    """The host's loop over an LM program's stages once ``setup`` has run:
    one read of the converged flag, then per iteration a ``step``, one
    read of its flags (``lm.LMStep``) and an ``accept`` or ``reject``, to
    the budget or convergence.  Every process of a mesh reads the same
    flags, so all replay the same stages.  Returns the iterations run."""
    t = prog.t
    budget = min(config.max_iterations if iter_budget is None
                 else int(iter_budget), config.max_iterations)
    iteration = 0
    if bool(t["converged"]):
        return iteration
    while iteration < budget:
        prog.run("step")
        before, accepting, after = t["step"].flags.tolist()
        if before:
            break
        prog.run("accept" if accepting else "reject")
        iteration += 1
        if after:
            break
    return iteration


def _lm_stages(aruco_size: float, config: LMConfig, n_caps: int, n_tags: int,
               bounds: dict | None, assemble_fn=None) -> dict:
    """The LM loop's stages over the tensors ``setup`` makes from the
    inputs: the grouped hooks at the slot ``bounds``, or with ``bounds``
    None the flat hooks (``lm.flat_solver``, with ``assemble_fn``); the
    hooks built by ``setup`` (its regroup tables, the flat sums' plans)
    serve the later stages."""
    hooks = {}

    def setup(t):
        make = grouped_solver if bounds is not None else flat_solver
        lin_fn, quality_fn, solve_fn, sol = make(
            t["cap_idx"], t["tag_idx"], t["corners"], t["block_mask"],
            t["cam_active"], t["cap_active"], t["tag_active"],
            aruco_size=aruco_size, config=config, n_caps=n_caps,
            n_tags=n_tags, **(bounds if bounds is not None
                              else dict(assemble_fn=assemble_fn)))
        hooks.update(lin=lin_fn, quality=quality_fn, solve=solve_fn)
        state, eqs = lm_init(t["in_camera"], t["in_cap_poses"],
                             t["in_tag_poses"], t["cam_active"],
                             t["cap_active"], t["tag_active"], lin_fn, config)
        # cost0 apart from the cost that the iterations overwrite in place
        return {**fields(state), "cost0": state.cost.clone(), "eqs": eqs,
                "sol": sol}

    def step(t):
        return {"step": lm_step(state_of(t), t["eqs"], t["sol"],
                                hooks["solve"], hooks["quality"], config)}

    def accept(t):
        state, eqs, sol = lm_accept(state_of(t), t["step"], hooks["lin"],
                                    t["cam_active"], t["cap_active"],
                                    t["tag_active"], config)
        return {**fields(state), "eqs": eqs, "sol": sol}

    def reject(t):
        state, sol = lm_reject(state_of(t), t["step"])
        return {**fields(state), "sol": sol}

    return {"setup": setup, "step": step, "accept": accept, "reject": reject}


def lm_solve_graphed(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                     block_mask, cam_active, cap_active, tag_active, *,
                     aruco_size: float, config: LMConfig,
                     obs_per_tag: int | None = None,
                     obs_per_cap: int | None = None, row_slots=None,
                     tag_rows=None, cap_rows=None, assemble_fn=None,
                     enabled=True, iter_budget=None, lam0=None, nu0=None,
                     graphed: bool = True):
    """``lm_solve``'s LM through the split stages: replayed CUDA graphs
    (``graphed``, a CUDA device), or the same stages run eagerly.  The
    grouped hooks at the bounds ``lm.grouped_bounds`` gives; without
    ``obs_per_tag``, or with an ``assemble_fn``, the flat hooks.  Returns
    (camera, cap_poses, tag_poses, info) as ``lm_core`` does, bit for
    bit."""
    dev = cap_poses.device
    if graphed and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
    n_caps, n_tags = cap_poses.shape[0], tag_poses.shape[0]
    bounds = None
    if obs_per_tag is not None and assemble_fn is None:
        bounds = dict(obs_per_tag=obs_per_tag, obs_per_cap=obs_per_cap,
                      row_slots=row_slots, tag_rows=tag_rows,
                      cap_rows=cap_rows)
    if not isinstance(cam_active, torch.Tensor):
        cam_active = torch.full((), bool(cam_active), dtype=torch.bool,
                                device=dev)

    def make():
        return Program(_lm_stages(aruco_size, config, n_caps, n_tags, bounds,
                                  assemble_fn), graphed)

    if graphed:
        # the flat hooks keyed by their assemble_fn, as JAX's static_argnames
        hooks = ("flat", assemble_fn) if bounds is None else tuple(
            bounds.items())
        prog = CACHE.get("lm", dev, (cap_poses.dtype, n_caps, n_tags,
                                     cap_idx.shape[0], hooks, config,
                                     float(aruco_size)), make)
    else:
        prog = make()
    prog.load(in_camera=camera, in_cap_poses=cap_poses,
              in_tag_poses=tag_poses, cap_idx=cap_idx, tag_idx=tag_idx,
              corners=corners, block_mask=block_mask, cam_active=cam_active,
              cap_active=cap_active, tag_active=tag_active)
    t = prog.t
    prog.run("setup")
    if lam0 is not None:
        t["lam"].fill_(lam0)
    if nu0 is not None:
        t["nu"].fill_(nu0)
    if not enabled:
        t["converged"].fill_(True)
        t["term"].fill_(5)
    iteration = lm_iterate(prog, config, iter_budget)
    return (prog.out(t["camera"]), prog.out(t["cap_poses"]),
            prog.out(t["tag_poses"]), lm_info(prog, iteration))


def seed_waves_graphed(camera, cap_poses, tag_poses, tag_idx, corners,
                       tables, *, aruco_size: float, seed_mode: str,
                       graphed: bool = True):
    """``batch.seed_waves`` as the ``seed`` stage of a program: a replayed
    CUDA graph (``graphed``, a CUDA device) or the stage run eagerly.
    Returns new (cap_poses, tag_poses), bit for bit ``seed_waves``'s."""
    dev = cap_poses.device
    if graphed and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")

    def seed(t):
        cap, tag = seed_waves(t["camera"], t["in_cap_poses"],
                              t["in_tag_poses"], t["tag_idx"], t["corners"],
                              t["tables"], aruco_size=aruco_size,
                              seed_mode=seed_mode)
        return {"cap_poses": cap, "tag_poses": tag}

    def make():
        return Program({"seed": seed}, graphed)

    if graphed:
        prog = CACHE.get("seed", dev, (
            cap_poses.dtype, cap_poses.shape[0], tag_poses.shape[0],
            corners.shape[0], *tables.shape, float(aruco_size), seed_mode),
            make)
    else:
        prog = make()
    prog.load(camera=camera, in_cap_poses=cap_poses, in_tag_poses=tag_poses,
              tag_idx=tag_idx, corners=corners, tables=tables)
    prog.run("seed")
    return prog.out(prog.t["cap_poses"]), prog.out(prog.t["tag_poses"])


_LOC_STATE = ("pose", "lam", "nu", "cost", "it", "conv")


def localize_graphed(camera, tag_poses, q_tag_idx, q_corners, q_block_mask,
                     q_seed_slot, *, aruco_size: float, config: LMConfig,
                     seed_mode: str = "hybrid", graphed: bool = True):
    """``localize_batch`` as the stages ``init`` (the seeds) and
    ``iterate`` (one iteration): replayed CUDA graphs (``graphed``, a
    CUDA device) or the same stages run eagerly.  Returns (poses, costs,
    iterations), bit for bit ``localize_batch``'s."""
    dev = camera.device
    if graphed and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")

    def init(t):
        s = localize_init(t["camera"], t["tag_poses"], t["q_tag_idx"],
                          t["q_corners"], t["q_block_mask"], t["q_seed_slot"],
                          aruco_size=aruco_size, config=config,
                          seed_mode=seed_mode)
        return {**s, "any_active": (~s["conv"]).any()}

    def iterate(t):
        new = localize_iteration(
            t["camera"], t["q_corners"], t["tps"], t["maskf"],
            *(t[k] for k in _LOC_STATE), aruco_size=aruco_size,
            config=config)
        return {**new, "any_active": (~new["conv"]).any()}

    def make():
        return Program({"init": init, "iterate": iterate}, graphed)

    if graphed:
        prog = CACHE.get("localize", dev, (
            camera.dtype, tuple(q_tag_idx.shape), tag_poses.shape[0], config,
            float(aruco_size), seed_mode), make)
    else:
        prog = make()
    prog.load(camera=camera, tag_poses=tag_poses, q_tag_idx=q_tag_idx,
              q_corners=q_corners, q_block_mask=q_block_mask,
              q_seed_slot=q_seed_slot)
    t = prog.t
    prog.run("init")
    active = bool(t["any_active"])
    for _ in range(config.max_iterations):
        if not active:
            break
        prog.run("iterate")
        active = bool(t["any_active"])
    return prog.out(t["pose"]), prog.out(t["cost"]), prog.out(t["it"])
