"""Distributed LM: TAG-SHARDED Schur elimination over a device mesh (port
of ar_slam_tpu/parallel/dist_lm.py).

The tag (landmark) axis is partitioned over a 1-D mesh and the block
(observation) table repacked so that each shard holds exactly its tags'
observations (``partition.prepare_tag_shards``).  Each LM iteration then:

- linearizes and assembles the TAG-side blocks (per-tag 6x6 V, the
  capture-sparse (t, S, 6, 6) coupling, the tag gradients) on each shard;
  they never leave it;
- reduces the CAPTURE-side blocks over the shards (~C*63 numbers);
- Schur-eliminates each shard's tags on that shard and reduces the
  additive reduced system (dense path), or runs the implicit-Schur CG
  with one packed (3 + 6C,) reduction per matvec (``linear_solver="cg"``);
- solves the dense reduced system once, replicated on the mesh's home
  device, and back-substitutes each shard's tag steps locally; the tag
  poses stay sharded (``Sharded``) for the whole solve.

Each shard's work is a function over that shard, enqueued on its device
through ``Mesh.map``; values replicated on the home device reach the
shards' cards through ``Mesh.put``, outside the shards' work.
``_psum_packed`` is the one reduction: the shards' arrays raveled into
one vector each, summed over the local shards on the home device in
shard order, then, with a process group of several processes, one
``all_reduce``.  A dense LM iteration costs exactly TWO reductions (the
solve's, and the fused step quality + speculative relinearization of
``make_quality_lin``); a CG solve one at setup and one per matvec.  The
tag-side sums the LM loop itself needs (the parameter test's norms, the
gradient test's max) ride the same packs, so processes agree on every
host decision without another collective.  The mesh counts the
reductions (``Mesh.reductions``).

The loop runs as the stages of solve/graphs.py (``setup``, ``step``,
``accept``, ``reject``) with the fused quality (``lm.lm_step``'s
``quality_lin_fn``) and their host loop (``graphs.lm_iterate``);
a flush's seeds as one stage ``seed`` over the padded wave tables
(``seed_waves_sharded``).  On a CUDA mesh the stages are captured once
per signature and replayed as CUDA graphs, the counterparts of the JAX
package's jitted ``_dist_lm_runner`` and ``_dist_wave_solver`` (one XLA
executable over ``shard_map``): one graph a stage spans the mesh's cards
(``programs.Program`` with ``mesh``), each shard's work on a branch
stream of its own that forks from its card's stream and rejoins it at
each packed reduction, the copies between cards and, with a process
group, the NCCL ``all_reduce`` inside it.  The CPU and ``graphs=False``
run the same stages eagerly, not captured (``programs.graphed`` of the
mesh's home decides); graphed and eager give the same values bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.core.seeding import (seed_capture_pose_multi,
                                            seed_tag_pose)
from ar_slam_tpu_torch.graph.arrays import obs_bucket
from ar_slam_tpu_torch.parallel.mesh import Mesh, Sharded, replicate
from ar_slam_tpu_torch.parallel.multihost import fetch, put_global
from ar_slam_tpu_torch.parallel.partition import prepare_tag_shards
from ar_slam_tpu_torch.solve.batch import pack_waves
from ar_slam_tpu_torch.programs import CACHE, Program
from ar_slam_tpu_torch.solve.graphs import (fields, lm_info, lm_iterate,
                                            state_of)
from ar_slam_tpu_torch.solve.lm import (LMConfig, lm_accept, lm_init,
                                        lm_reject, lm_step)
from ar_slam_tpu_torch.solve.residuals import linearize
from ar_slam_tpu_torch.solve.schur import (CapEqs, CgShard, TagRows,
                                           assemble_grouped,
                                           backsub_tags_sparse,
                                           cap_scale_vectors,
                                           eliminate_tags_grouped,
                                           group_blocks_by_tag,
                                           group_blocks_by_tag_rows,
                                           quad_form_cap_side,
                                           quad_form_tag_side, reduced_solve,
                                           schur_solve_sharded_cg)


class ShardedEqs(NamedTuple):
    """The normal equations of a tag-sharded solve."""

    cap: CapEqs  # replicated, on the mesh's home device
    tags: list  # per local shard: (hct, wt_s, htt, g_t)
    g_t_max: torch.Tensor  # max |g_t| over the active tags of every shard
    tag_sq: torch.Tensor  # sum of the squared tag poses they were taken at
    step_sq: torch.Tensor  # sum of the squared tag step that proposed them


def _psum_packed(mesh: Mesh, shard_arrs):
    """ONE reduction for several same-dtype arrays: ``shard_arrs`` holds
    one list of arrays per local shard; each list is raveled and
    concatenated, the shards' vectors summed on the home device (with
    several processes then all-reduced once), and the sum split back into
    the arrays' shapes, on the home device; a shard that consumes a value
    moves it to its device.  Packing keeps each stage at one collective:
    on latency-bound links the count matters more than the bytes, and the
    payloads here are small."""
    shapes = [a.shape for a in shard_arrs[0]]
    dtypes = {a.dtype for arrs in shard_arrs for a in arrs}
    assert len(dtypes) == 1, (
        f"_psum_packed requires one dtype, got {sorted(map(str, dtypes))}: "
        "concatenate would silently promote and change downstream dtypes")
    flats = mesh.map(lambda arrs: torch.cat([a.reshape(-1) for a in arrs]),
                     shard_arrs)
    flat = None
    for f in flats:  # in shard order, on the home device
        f = f.to(mesh.home)
        flat = f if flat is None else flat + f
    if mesh.group is not None and mesh.world > 1:
        import torch.distributed as dist

        dist.all_reduce(flat, group=mesh.group)
    mesh.reductions += 1
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[off:off + n].reshape(s))
        off += n
    return out


class _Group(NamedTuple):
    """One shard's grouped block table (``make_group``): slot tables with
    SHARD-LOCAL tag ids."""

    cap_idx: torch.Tensor
    tag_idx: torch.Tensor
    corners: torch.Tensor
    mask: torch.Tensor
    cap_gather: torch.Tensor
    cap_gmask: torch.Tensor
    rows: TagRows | None
    cap_rows: TagRows | None


def make_tag_sharded_hooks(mesh: Mesh, t_per, n_caps, aruco_size,
                           jacobi_scaling=True, distortion=False,
                           obs_per_tag: int = 8, obs_per_cap: int = 8,
                           loss="trivial", loss_scale=1.0,
                           linear_solver: str = "dense",
                           cg_tol: float = 1e-2, cg_iters: int = 100,
                           row_slots: int | None = None,
                           shard_rows: int | None = None,
                           shard_cap_rows: int | None = None):
    """(make_group, make_lin, make_quality_lin, make_solve) for the LM's
    stages (``lm.lm_step`` and its kin) with the tags sharded over
    ``mesh``.

    Tag-indexed arrays are in the RENUMBERED order of
    ``prepare_tag_shards`` (global count t_per * n_shards), as ``Sharded``
    (t_per, ...) tensors; block ``tag_idx`` holds the new GLOBAL ids.
    ``obs_per_tag`` / ``obs_per_cap`` are the static slot counts of the
    grouped assembly (global maxima, shared by all shards).  For CG,
    ``row_slots`` / ``shard_rows`` / ``shard_cap_rows`` switch each
    shard's tables to the ROW-SPLIT layout, sized for the heaviest shard.
    The JAX package's ``make_quality`` is not ported: the loop takes the
    fused ``make_quality_lin`` whenever the hooks are sharded."""
    use_rows = row_slots is not None and linear_solver == "cg"
    use_cap_rows = use_rows and shard_cap_rows is not None
    s_max = row_slots if use_rows else obs_per_tag
    max_rows = -(-obs_per_tag // row_slots) if use_rows else 1
    max_cap_rows = -(-obs_per_cap // row_slots) if use_cap_rows else 1
    gs = list(mesh.shard_ids())

    def make_group(cap_idx, tag_idx, corners, block_mask):
        """Regroup each shard's blocks by local tag into (t_per * S) slots
        (row-split: shard_rows * row_slots) and by capture: one ``_Group``
        a shard, built once a solve."""
        def one(g, ci, ti, crn, bm):
            til = ti - g * t_per
            dev = til.device
            if use_rows:
                gather, mask_g, rows = group_blocks_by_tag_rows(
                    til, bm, t_per, row_slots, shard_rows, max_rows)
                til_g = rows.row_tag[:, None].expand(
                    shard_rows, row_slots).reshape(-1)
            else:
                gather, mask_g = group_blocks_by_tag(til, bm, t_per, s_max)
                rows = None
                til_g = torch.arange(t_per, device=dev)[:, None].expand(
                    t_per, s_max).reshape(-1)
            ci_g = ci[gather]
            if use_cap_rows:
                cap_gather, cap_gmask, cap_rows = group_blocks_by_tag_rows(
                    ci_g, mask_g, n_caps, row_slots, shard_cap_rows,
                    max_cap_rows)
            else:
                cap_gather, cap_gmask = group_blocks_by_tag(
                    ci_g, mask_g, n_caps, obs_per_cap)
                cap_rows = None
            return _Group(ci_g, til_g, crn[gather], mask_g, cap_gather,
                          cap_gmask, rows, cap_rows)

        return mesh.map(one, gs, cap_idx, tag_idx, corners, block_mask)

    def _assemble(camera, cap_poses, tags, grp):
        """One shard's linearization and tag-grouped assembly, ``camera``
        and ``cap_poses`` on its device."""
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tags, grp.cap_idx, grp.tag_idx, grp.corners,
            grp.mask, aruco_size, distortion, loss, loss_scale)
        eqs = assemble_grouped(r, jc, jp, jt, grp.cap_gather, grp.cap_gmask,
                               n_caps, t_per, s_max, rows=grp.rows,
                               cap_rows=grp.cap_rows)
        return eqs, 0.5 * torch.sum(rho)

    def _g_t_max(g, g_t, tag_active):
        """This shard's max |g_t| over its active tags, at its slot of an
        (n_shards,) vector: the sum over shards holds every shard's."""
        dt = g_t.dtype
        m = torch.max(torch.abs(g_t) * tag_active[:, None].to(dt))
        slot = torch.arange(mesh.n_shards, device=g_t.device) == g
        return slot.to(dt) * m

    def _eqs(packed, tag_side):
        hcc, hcp, hpp, g_c, g_p, cost, g_max, tag_sq, step_sq = packed
        return ShardedEqs(CapEqs(hcc, hcp, hpp, g_c, g_p), tag_side,
                          torch.max(g_max), tag_sq, step_sq), cost

    def make_lin(grouped, tag_active):
        def lin_fn(camera, cap_poses, tag_poses):
            def one(g, cam, caps, tags, grp, ta):
                e, cost = _assemble(cam, caps, tags, grp)
                return (e.hct, e.wt_s, e.htt, e.g_t), [
                    e.hcc, e.hcp, e.hpp, e.g_c, e.g_p, cost,
                    _g_t_max(g, e.g_t, ta), torch.sum(tags ** 2),
                    torch.zeros_like(cost)]

            out = mesh.map(one, gs, mesh.put(camera), mesh.put(cap_poses),
                           tag_poses, grouped, tag_active)
            return _eqs(_psum_packed(mesh, [o[1] for o in out]),
                        [o[0] for o in out])

        return lin_fn

    def make_quality_lin(grouped, tag_active):
        """Fused step quality + SPECULATIVE relinearization at the
        proposed parameters: the quality scalars ride the same packed
        reduction as the relinearized capture-side blocks (two reductions
        an iteration instead of three).  d^T g and d^T H d come from the
        CURRENT eqs (quad_form_*); the extra Jacobians of a rejected step
        are local work."""
        def quality_lin_fn(eqs, new_camera, new_caps, new_tags, d_cam,
                           d_cap, d_tag):
            def one(g, cam, caps, dcam, dcap, tags, dt_, grp, ta, old):
                e, cost = _assemble(cam, caps, tags, grp)
                gd_t, q_t = quad_form_tag_side(*old, grp.cap_idx, dcam, dcap,
                                               dt_, rows=grp.rows)
                return (e.hct, e.wt_s, e.htt, e.g_t), [
                    e.hcc, e.hcp, e.hpp, e.g_c, e.g_p, cost,
                    _g_t_max(g, e.g_t, ta), torch.sum(tags ** 2),
                    torch.sum(dt_ ** 2), gd_t, q_t]

            out = mesh.map(one, gs, mesh.put(new_camera), mesh.put(new_caps),
                           mesh.put(d_cam), mesh.put(d_cap), new_tags, d_tag,
                           grouped, tag_active, eqs.tags)
            packed = _psum_packed(mesh, [o[1] for o in out])
            gd_t, q_t = packed[-2:]
            new_eqs, new_cost = _eqs(packed[:-2], [o[0] for o in out])
            # the capture side is replicated: added after the reduction
            gd_c, q_c = quad_form_cap_side(*eqs.cap, d_cam, d_cap)
            return new_cost, gd_c + gd_t, q_c + q_t, new_eqs

        return quality_lin_fn

    def make_solve(cam_active, cap_active, tag_active, grouped):
        if linear_solver == "cg":
            def solve_fn(eqs, lam, x0):
                cg_shards = [CgShard(*side, grp.cap_idx, grp.cap_gather,
                                     grp.cap_gmask, ta, grp.rows,
                                     grp.cap_rows)
                             for side, grp, ta in zip(eqs.tags, grouped,
                                                      tag_active)]
                d_cam, d_cap, d_tags, delta_r = schur_solve_sharded_cg(
                    eqs.cap, cg_shards, lam, cam_active, cap_active,
                    lambda per_shard: _psum_packed(mesh, per_shard),
                    jacobi_scaling=jacobi_scaling, cg_tol=cg_tol,
                    cg_iters=cg_iters, x0=x0, fan=mesh)
                return d_cam, d_cap, Sharded(d_tags), delta_r

            return solve_fn

        def solve_fn(eqs, lam):
            s_c, s_p = cap_scale_vectors(eqs.cap, cam_active, cap_active,
                                         jacobi_scaling)

            def eliminate(side, grp, ta, sc, sp, lm):
                hct, wt_s, htt, g_t = side
                wvw, wvg, ctx = eliminate_tags_grouped(
                    hct, wt_s, grp.cap_idx, htt, g_t, sc, sp, ta, lm,
                    jacobi_scaling)
                return [wvw, wvg], ctx

            out = mesh.map(eliminate, eqs.tags, grouped, tag_active,
                           mesh.put(s_c), mesh.put(s_p), mesh.put(lam))
            wvw, wvg = _psum_packed(mesh, [o[0] for o in out])
            delta_r, d_cam, d_cap = reduced_solve(
                eqs.cap, s_c, s_p, cam_active, cap_active, lam, wvw, wvg)

            def backsub(ctx, grp, ta, dr):
                v_inv, hct_s, wt_ss, g_t_s, s_t = ctx
                return backsub_tags_sparse(v_inv, hct_s, wt_ss, grp.cap_idx,
                                           g_t_s, s_t, ta, dr)

            d_tag = Sharded(mesh.map(backsub, [o[1] for o in out], grouped,
                                     tag_active, mesh.put(delta_r)))
            return d_cam, d_cap, d_tag

        return solve_fn

    return make_group, make_lin, make_quality_lin, make_solve


class TagShardedProblem:
    """Host-side prep: tag renumbering, block repack and placement on the
    mesh; converts results back to the original tag numbering.  Float
    arrays take ``dtype`` (default: their numpy dtype)."""

    def __init__(self, mesh: Mesh, cap_idx, tag_idx, corners, block_mask,
                 n_tags, dtype=None):
        self.mesh = mesh
        self.n_dev = mesh.n_shards
        self.dtype = dtype
        cap_idx = np.asarray(cap_idx)
        tag_idx = np.asarray(tag_idx)
        corners = np.asarray(corners)
        block_mask = np.asarray(block_mask)
        self.prep = prepare_tag_shards(cap_idx, tag_idx, block_mask, n_tags,
                                       self.n_dev)
        p = self.prep
        # static slot counts of the grouped assembly: the global max
        # observations per tag / capture, bucketed (shared by all shards)
        counts = np.bincount(tag_idx[block_mask], minlength=n_tags)
        self.obs_per_tag = obs_bucket(int(counts.max()) if counts.size
                                      else 1)
        ccounts = np.bincount(cap_idx[block_mask])
        self.obs_per_cap = obs_bucket(int(ccounts.max()) if ccounts.size
                                      else 1)
        # per-shard ROW-SPLIT budget of the CG path: the rows of the
        # heaviest shard (each shard owns a contiguous range of new tags)
        self.row_slots = 8
        new_counts = np.bincount(p["new_tag_idx"][p["row_mask"]],
                                 minlength=p["t_new"])
        rows_per_tag = -(-new_counts // self.row_slots)
        per_shard = rows_per_tag.reshape(self.n_dev, p["t_per"]).sum(axis=1)
        self.shard_rows = obs_bucket(int(per_shard.max()) if per_shard.size
                                     else 1)
        # per-shard CAPTURE-row budget: each shard groups its slots by
        # capture; sized for the heaviest shard
        b_shard = p["b_shard"]
        ci_new = cap_idx[p["row_gather"]]
        worst = 1
        for s in range(self.n_dev):
            sl = slice(s * b_shard, (s + 1) * b_shard)
            m = p["row_mask"][sl]
            if m.any():
                cc = np.bincount(ci_new[sl][m])
                worst = max(worst, int((-(-cc // self.row_slots)).sum()))
        self.shard_cap_rows = obs_bucket(worst)
        self.t_per = p["t_per"]
        self.t_new = p["t_new"]
        self.b_shard = b_shard
        rg = p["row_gather"]
        self.cap_idx = self.put_blocks(cap_idx[rg])
        self.tag_idx = self.put_blocks(p["new_tag_idx"])
        self.corners = self.put_blocks(corners[rg])
        self.base_mask = p["row_mask"]

    def put_blocks(self, arr) -> Sharded:
        return put_global(arr, self.mesh, dtype=self.dtype)

    def put_tags(self, arr) -> Sharded:
        """Permute an old-tag-indexed array into shard order and place it.
        Padding slots (which gather old tag 0's row) are zeroed so they
        contribute nothing to norms/costs."""
        out = _numpy(arr)[self.prep["tag_perm"]].copy()
        invalid = ~self.prep["tag_slot_valid"]
        if invalid.any():
            out[invalid] = 0
        return put_global(out, self.mesh, dtype=self.dtype)

    def put_tag_mask(self, mask_old) -> Sharded:
        """Permute an activity mask, forcing padding tag slots inactive
        (they alias old tag 0's row and must not become parameters)."""
        m = _numpy(mask_old)[self.prep["tag_perm"]]
        return put_global(m & self.prep["tag_slot_valid"], self.mesh)

    def put_rep(self, *arrs):
        return replicate(self.mesh, *map(_numpy, arrs), dtype=self.dtype)

    def block_mask(self, active_old) -> Sharded:
        """Map an old-row activity mask into the repacked layout."""
        m = _numpy(active_old)[self.prep["row_gather"]] & self.base_mask
        return self.put_blocks(m)

    def tags_to_old(self, arr_new, n_old) -> np.ndarray:
        """Inverse-permute a tag-indexed result back to old numbering (all
        of it on every process: ``multihost.fetch`` all-gathers)."""
        return fetch(arr_new, self.mesh)[self.prep["tag_inv"][:n_old]]

    def row_of_block(self, old_row) -> int:
        return int(self.prep["row_of_block"][old_row])


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _signature(prob: TagShardedProblem, dtype, n_caps: int, *rest) -> tuple:
    """A mesh program's static signature: the mesh's layout, the dtype and
    the padded shard shapes, then ``rest``."""
    mesh = prob.mesh
    return (tuple(map(str, mesh.devices)), mesh.world, mesh.rank, dtype,
            n_caps, prob.t_per, prob.b_shard, *rest)


def _hooks(prob: TagShardedProblem, aruco_size, config: LMConfig,
           n_caps: int):
    return make_tag_sharded_hooks(
        prob.mesh, prob.t_per, n_caps, aruco_size, config.jacobi_scaling,
        config.enable_distortion, prob.obs_per_tag, prob.obs_per_cap,
        loss=config.loss, loss_scale=config.loss_scale,
        linear_solver=config.linear_solver, cg_tol=config.cg_tolerance,
        cg_iters=config.cg_max_iterations, row_slots=prob.row_slots,
        shard_rows=prob.shard_rows, shard_cap_rows=prob.shard_cap_rows)


def _lm_stages(prob: TagShardedProblem, aruco_size, config: LMConfig,
               n_caps: int) -> dict:
    """The tag-sharded LM's stages: ``setup`` (the per-shard regroup, the
    first linearization and its reduction, the initial state), ``step``
    (``lm_step`` over the fused quality: the damped solve, the quality
    and relinearization, the tests), ``accept`` (adopt the
    relinearization) and ``reject``.  The hooks ``setup`` builds serve the later stages."""
    make_group, make_lin, make_quality_lin, make_solve = _hooks(
        prob, aruco_size, config, n_caps)
    hooks = {}

    def active(t):
        return t["cam_active"], t["cap_active"], t["tag_active"]

    def setup(t):
        grouped = make_group(t["cap_idx"], t["tag_idx"], t["corners"],
                             t["block_mask"])
        lin_fn = make_lin(grouped, t["tag_active"])
        hooks.update(quality=make_quality_lin(grouped, t["tag_active"]),
                     solve=make_solve(*active(t), grouped))
        state, eqs = lm_init(t["in_camera"], t["in_cap_poses"],
                             t["in_tag_poses"], *active(t), lin_fn, config)
        sol = None
        if config.linear_solver == "cg":
            sol = torch.zeros(3 + 6 * n_caps, dtype=state.cap_poses.dtype,
                              device=state.cap_poses.device)
        return {**fields(state), "cost0": state.cost.clone(), "eqs": eqs,
                "sol": sol}

    def step(t):
        return {"step": lm_step(state_of(t), t["eqs"], t["sol"],
                                hooks["solve"], None, config,
                                quality_lin_fn=hooks["quality"],
                                active=active(t))}

    def accept(t):
        state, eqs, sol = lm_accept(state_of(t), t["step"], None,
                                    *active(t), config)
        return {**fields(state), "eqs": eqs, "sol": sol}

    def reject(t):
        state, sol = lm_reject(state_of(t), t["step"])
        return {**fields(state), "sol": sol}

    return {"setup": setup, "step": step, "accept": accept, "reject": reject}


def lm_solve_sharded(prob: TagShardedProblem, aruco_size, config: LMConfig,
                     camera, cap_poses, tag_poses, block_mask, cam_active,
                     cap_active, tag_active, enabled=True, iter_budget=None,
                     graphs: bool = True):
    """The tag-sharded LM on placed state and masks (the tags ``Sharded``
    in the renumbered order) through its stages: replayed CUDA graphs
    where ``programs.graphed`` allows on the mesh's home, else the same
    stages eagerly, driven by ``graphs.lm_iterate``: an iteration is a
    ``step``, one read of its flags and an ``accept`` or ``reject``.
    Returns (camera, cap_poses, tag_poses, info), placed as the inputs
    are; the mesh counts the packed reductions the stages run."""
    mesh = prob.mesh
    n_caps = cap_poses.shape[0]
    graphed = programs.graphed(mesh.home, graphs)

    kind = "mesh_lm"

    def make():
        return Program(_lm_stages(prob, aruco_size, config, n_caps), graphed,
                       mesh=mesh, kind=kind)

    if graphed:
        cg = config.linear_solver == "cg"
        prog = CACHE.get(kind, mesh.home, _signature(
            prob, cap_poses.dtype, n_caps, prob.obs_per_tag,
            prob.obs_per_cap,
            (prob.row_slots, prob.shard_rows, prob.shard_cap_rows) if cg
            else None,
            # the budget is the host's: one capture serves every budget
            config._replace(max_iterations=0), float(aruco_size)), make)
        prog.counted = ((mesh, "reductions"),)
    else:
        prog = make()
    prog.load(in_camera=camera, in_cap_poses=cap_poses,
              in_tag_poses=tag_poses, cap_idx=prob.cap_idx,
              tag_idx=prob.tag_idx, corners=prob.corners,
              block_mask=block_mask, cam_active=cam_active,
              cap_active=cap_active, tag_active=tag_active)
    t = prog.t
    prog.run("setup")
    if not enabled:
        t["converged"].fill_(True)
        t["term"].fill_(5)
    iteration = lm_iterate(prog, config, iter_budget)
    return (prog.out(t["camera"]), prog.out(t["cap_poses"]),
            prog.out(t["tag_poses"]), lm_info(prog, iteration))


def lm_solve_dist(mesh: Mesh, camera, cap_poses, tag_poses, cap_idx,
                  tag_idx, corners, block_mask, cam_active, cap_active,
                  tag_active, *, aruco_size: float,
                  config: LMConfig = LMConfig(), graphs: bool = True):
    """Distributed lm_solve: the contract of solve.lm.lm_solve (arrays in
    the original tag numbering, numpy or tensors); tags and their
    observations are sharded internally, and the results come back in the
    original numbering on the mesh's home device, in the dtype of
    ``cap_poses``.  The LM replays CUDA graphs on a CUDA mesh
    (``programs.graphed``); ``graphs=False`` runs the same stages eagerly,
    bit for bit."""
    dtype = (cap_poses.dtype if isinstance(cap_poses, torch.Tensor)
             else torch.from_numpy(np.asarray(cap_poses)).dtype)
    n_tags = tag_poses.shape[0]
    prob = TagShardedProblem(mesh, _numpy(cap_idx), _numpy(tag_idx),
                             _numpy(corners), _numpy(block_mask), n_tags,
                             dtype=dtype)
    camera_r, cap_poses_r, cam_a, cap_a = prob.put_rep(
        camera, cap_poses, np.asarray(_numpy(cam_active), bool), cap_active)
    cam, caps, tags, info = lm_solve_sharded(
        prob, aruco_size, config, camera_r, cap_poses_r,
        prob.put_tags(tag_poses), prob.block_mask(block_mask), cam_a, cap_a,
        prob.put_tag_mask(tag_active), graphs=graphs)
    tags_old = torch.as_tensor(prob.tags_to_old(tags, n_tags),
                               device=mesh.home)
    return cam, caps, tags_old, info


def seed_waves_sharded(mesh: Mesh, t_per: int, b_shard: int, camera,
                       cap_poses, tag_poses, tag_idx, corners, tables, *,
                       aruco_size, seed_mode) -> tuple:
    """``solve.batch.seed_waves`` on the tag-sharded layout, with no host
    read (≙ the JAX package's ``apply_wave_seeds`` inside
    ``_dist_wave_solver``): ``tables`` (``pack_waves``, replicated on the
    home device) hold REPACKED block rows and RENUMBERED tag ids;
    ``tag_poses``, ``tag_idx`` and ``corners`` are ``Sharded``.  A static
    loop over the W waves: each wave's anchor poses and corners come from
    the shards that own their rows through one packed reduction (the
    other shards add zeros), the capture is seeded on the home device
    where seed_block >= 0, and each shard initializes the wave's tags it
    owns from their rows through that capture (the other slots scatter
    into a spare row that is cut off).  Returns new (cap_poses,
    tag_poses)."""
    s = (tables.shape[1] - 2) // 5
    seed_caps, seed_blocks = tables[:, 0], tables[:, 1]
    anchor_mask = tables[:, 2 + 4 * s:] != 0
    cap_poses = cap_poses.clone()

    def prepare(g, tp, ti, crn, tab):
        w_tags, w_rows, w_mask, a_rows, a_mask = (
            tab[:, 2 + k * s:2 + (k + 1) * s] for k in range(5))
        lo = g * b_shard
        zero = torch.zeros_like(w_rows)
        own_w = (w_mask != 0) & (w_rows >= lo) & (w_rows < lo + b_shard)
        own_a = (a_mask != 0) & (a_rows >= lo) & (a_rows < lo + b_shard)
        loc_a = torch.where(own_a, a_rows - lo, zero)
        return dict(
            tags=torch.cat([tp, tp[:1]]), own_a=own_a[..., None],
            anc_tags=ti[loc_a] - g * t_per,  # (W, S) local ids
            anc_corners=crn[loc_a].reshape(*loc_a.shape, 8),
            init_corners=crn[torch.where(own_w, w_rows - lo, zero)],
            targets=torch.where(own_w, w_tags - g * t_per,
                                torch.full_like(w_tags, t_per)))

    shards = mesh.map(prepare, list(mesh.shard_ids()), tag_poses, tag_idx,
                      corners, mesh.put(tables))
    cameras = mesh.put(camera)
    for w in range(tables.shape[0]):
        def anchors(sh):
            own = sh["own_a"][w]
            poses = sh["tags"].index_select(0, sh["anc_tags"][w])
            crn = sh["anc_corners"][w]
            return [torch.where(own, poses, torch.zeros_like(poses)),
                    torch.where(own, crn, torch.zeros_like(crn))]

        anc_poses, anc_corners = _psum_packed(mesh, mesh.map(anchors, shards))
        cap = seed_caps[w:w + 1]
        pose = seed_capture_pose_multi(
            anc_corners.reshape(s, 4, 2), camera, anc_poses, anchor_mask[w],
            aruco_size, mode=seed_mode)
        pose = torch.where(seed_blocks[w] >= 0, pose,
                           cap_poses.index_select(0, cap)[0])
        cap_poses.index_copy_(0, cap, pose[None])

        def init_tags(sh, cam, p):
            sh["tags"].index_copy_(0, sh["targets"][w], seed_tag_pose(
                sh["init_corners"][w], cam, p, aruco_size, mode=seed_mode))

        mesh.map(init_tags, shards, cameras, mesh.put(pose))
    return cap_poses, Sharded(sh["tags"][:t_per] for sh in shards)


class DistWaveSolver:
    """The wave solver over a ``TagShardedProblem`` (seeding prologue and
    LM, ≙ the JAX package's jitted ``make_dist_wave_solver``); the solve
    drivers' ``_WaveRunner`` calls it for each flush.  Tag-indexed state
    is ``Sharded`` in the renumbered order.  Its programs (kinds
    ``mesh_seed`` and ``mesh_lm`` of ``programs.CACHE``) replay CUDA
    graphs where ``programs.graphed`` allows on the mesh's home."""

    def __init__(self, prob: TagShardedProblem, aruco_size: float,
                 config: LMConfig, seed_mode: str, graphs: bool = True):
        self.prob = prob
        self.aruco_size = aruco_size
        self.config = config
        self.seed_mode = seed_mode
        self.graphs = graphs

    def seed_waves(self, camera, cap_poses, tag_poses, waves, slots: int,
                   w_min: int = 1):
        """Apply the seeds of ``waves`` in order, as
        ``solve.batch.apply_wave_seeds_multi`` does on one table (waves in
        the store's block and tag numbering): their tables repacked into
        the shards' numbering, padded to (W, S) = (max(bucket(len(waves)),
        w_min), ``slots``) and uploaded in one copy, then one ``seed``
        stage (``seed_waves_sharded``).  Returns new (cap_poses,
        tag_poses)."""
        prob, mesh = self.prob, self.prob.mesh
        row_of, tag_inv = prob.prep["row_of_block"], prob.prep["tag_inv"]

        def rows(r):
            return row_of[np.asarray(r, dtype=np.int64)]

        tables = torch.as_tensor(pack_waves(
            [(cap, int(row_of[seed]) if seed >= 0 else -1, rows(r),
              tag_inv[np.asarray(tags, dtype=np.int64)], rows(anchors))
             for cap, seed, r, tags, anchors in waves], slots, w_min),
            device=mesh.home)
        kw = dict(aruco_size=self.aruco_size, seed_mode=self.seed_mode)
        graphed = programs.graphed(mesh.home, self.graphs)

        def seed(t):
            cap, tag = seed_waves_sharded(
                mesh, prob.t_per, prob.b_shard, t["camera"],
                t["in_cap_poses"], t["in_tag_poses"], t["tag_idx"],
                t["corners"], t["tables"], **kw)
            return {"cap_poses": cap, "tag_poses": tag}

        kind = "mesh_seed"

        def make():
            return Program({"seed": seed}, graphed, mesh=mesh, kind=kind)

        if graphed:
            prog = CACHE.get(kind, mesh.home, _signature(
                prob, cap_poses.dtype, cap_poses.shape[0], *tables.shape,
                float(self.aruco_size), self.seed_mode), make)
            prog.counted = ((mesh, "reductions"),)
        else:
            prog = make()
        prog.load(camera=camera, in_cap_poses=cap_poses,
                  in_tag_poses=tag_poses, tag_idx=prob.tag_idx,
                  corners=prob.corners, tables=tables)
        prog.run("seed")
        return prog.out(prog.t["cap_poses"]), prog.out(prog.t["tag_poses"])

    def lm(self, camera, cap_poses, tag_poses, block_mask, cam_active,
           cap_active, tag_active, enabled=True, iter_budget=None):
        """The tag-sharded LM on placed state and masks
        (``lm_solve_sharded``)."""
        return lm_solve_sharded(self.prob, self.aruco_size, self.config,
                                camera, cap_poses, tag_poses, block_mask,
                                cam_active, cap_active, tag_active,
                                enabled=enabled, iter_budget=iter_budget,
                                graphs=self.graphs)


def make_dist_wave_solver(prob: TagShardedProblem, *, aruco_size: float,
                          config: LMConfig, seed_mode: str = "hybrid",
                          graphs: bool = True):
    """The distributed wave solver over ``prob``'s layout.  The JAX
    package memoizes its jitted program; here ``programs.CACHE`` holds the
    captured programs, so every solver of one signature shares them."""
    return DistWaveSolver(prob, aruco_size, config, seed_mode, graphs)
