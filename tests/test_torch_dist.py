"""Port parity: the tag-sharded distributed LM (parallel/dist_lm.py,
lm_solve_dist) against the JAX package's lm_solve_dist on a mesh of the
same size (conftest.py's 8 virtual CPU devices) and against the port's
single-device lm_solve, dense and CG, at 1, 2, 3 and 8 shards (3 leaves
padding tag slots, ≙ tests/test_dist.py:203), float64 on the CPU; the
reductions an LM iteration costs; and the tag partition through the copy
of partition.py.

The map (torch_cases.synthetic_arrays, seed 3) converges in 8 LM
iterations on every path.  CG runs at cg_tolerance 1e-10 with 100 steps,
so that its steps are exact and the LM path does not follow rounding.
Measured: the costs agree to 2e-13 relative, the poses to 2e-10.
"""

import jax
import numpy as np
import pytest
import torch

from ar_slam_tpu.parallel import block_mesh as j_block_mesh
from ar_slam_tpu.parallel import lm_solve_dist as j_lm_solve_dist
from ar_slam_tpu.parallel import prepare_tag_shards as j_prepare
from ar_slam_tpu_torch.convert import arrays_from_numpy
from ar_slam_tpu_torch.parallel import (TagShardedProblem, block_mesh,
                                        lm_solve_dist, prepare_tag_shards)
from ar_slam_tpu_torch.solve.lm import LMConfig, lm_solve
from torch_cases import slot_bounds, synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635
COST_RTOL, POSE_ATOL = 1e-10, 1e-8
CG_STEPS = 100


def _config(solver):
    return LMConfig(max_iterations=10, linear_solver=solver,
                    cg_tolerance=1e-10, cg_max_iterations=CG_STEPS)


@pytest.fixture(scope="module")
def arrs():
    return synthetic_arrays(seed=3)


@pytest.fixture(scope="module")
def single(arrs):
    """The port's single-device grouped lm_solve, dense and CG."""
    t = arrays_from_numpy(arrs, "cpu", torch.float64)
    bounds = slot_bounds(arrs)
    return {solver: lm_solve(
        t["camera"], t["cap_poses"], t["tag_poses"], t["cap_idx"],
        t["tag_idx"], t["corners"], t["block_mask"], True, t["cap_mask"],
        t["tag_mask"], aruco_size=SIZE, config=_config(solver),
        obs_per_tag=bounds[0], obs_per_cap=bounds[1])
        for solver in ("dense", "cg")}


def _port(arrs, solver, n):
    mesh = block_mesh(devices=["cpu"] * n)
    out = lm_solve_dist(
        mesh, arrs.camera, arrs.cap_poses, arrs.tag_poses, arrs.cap_idx,
        arrs.tag_idx, arrs.corners, arrs.block_mask, True, arrs.cap_mask,
        arrs.tag_mask, aruco_size=SIZE, config=_config(solver))
    return out, mesh


def _check(got, ref):
    """(camera, caps, tags, info) of two solves agree."""
    assert int(got[3]["iterations"]) == int(ref[3]["iterations"])
    np.testing.assert_allclose(float(got[3]["cost"]), float(ref[3]["cost"]),
                               rtol=COST_RTOL)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=POSE_ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_lm_solve_dist_matches_jax_and_single_device(arrs, single, solver,
                                                     n):
    """The same iterations, cost within 1e-10 relative and every pose
    within 1e-8 of JAX's lm_solve_dist on an n-device mesh and of the
    port's single-device solve; exactly one reduction at the first
    linearization and, per LM iteration, two (dense: the eliminated
    system, the fused step quality + relinearization) or CG_STEPS + 3
    (CG: its setup, CG_STEPS + 1 matvecs, the fused quality)."""
    assert len(jax.devices()) >= 8, "virtual mesh missing"
    ref = j_lm_solve_dist(
        j_block_mesh(n), arrs.camera, arrs.cap_poses, arrs.tag_poses,
        arrs.cap_idx, arrs.tag_idx, arrs.corners, arrs.block_mask,
        np.asarray(True), arrs.cap_mask, arrs.tag_mask, aruco_size=SIZE,
        config=_config(solver))
    got, mesh = _port(arrs, solver, n)
    _check(got, ref)
    _check(got, single[solver])
    iters = int(got[3]["iterations"])
    per_iter = 2 if solver == "dense" else CG_STEPS + 3
    assert mesh.reductions == 1 + per_iter * iters


def test_reductions_per_dense_iteration(arrs):
    """Budgets of 1, 2 and 3 LM iterations: each iteration adds exactly
    two reductions (≙ docs/distributed.md step 6)."""
    counts = []
    for budget in (1, 2, 3):
        mesh = block_mesh(devices=["cpu"] * 4)
        config = LMConfig(max_iterations=budget)
        _, _, _, info = lm_solve_dist(
            mesh, arrs.camera, arrs.cap_poses, arrs.tag_poses, arrs.cap_idx,
            arrs.tag_idx, arrs.corners, arrs.block_mask, True, arrs.cap_mask,
            arrs.tag_mask, aruco_size=SIZE, config=config)
        assert int(info["iterations"]) == budget
        counts.append(mesh.reductions)
    assert counts == [3, 5, 7]


@pytest.mark.parametrize("n", [3, 4])
def test_prepare_tag_shards_structure(arrs, n):
    """The copy's partition equals the JAX package's, field for field, and
    keeps its invariants: every tag in one shard, every active block in
    its tag's shard slice, row maps that invert, padding rows masked and
    tag-local."""
    t_pad = arrs.tag_poses.shape[0]
    p = prepare_tag_shards(arrs.cap_idx, arrs.tag_idx, arrs.block_mask,
                           t_pad, n)
    ref = j_prepare(arrs.cap_idx, arrs.tag_idx, arrs.block_mask, t_pad, n)
    assert p.keys() == ref.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], ref[k])
    t_per = p["t_per"]
    assert p["t_new"] == t_per * n
    assert len(set(p["tag_inv"].tolist())) == t_pad
    rg, rob = p["row_gather"], p["row_of_block"]
    for old in np.nonzero(arrs.block_mask)[0]:
        assert rg[rob[old]] == old
        new_tid = p["tag_inv"][arrs.tag_idx[old]]
        assert rob[old] // p["b_shard"] == new_tid // t_per
    for s in range(n):
        sl = slice(s * p["b_shard"], (s + 1) * p["b_shard"])
        tids = p["new_tag_idx"][sl]
        assert np.all((tids >= s * t_per) & (tids < (s + 1) * t_per))
        assert not p["row_mask"][sl][len(np.nonzero(
            p["row_mask"][sl])[0]):].any()


def test_padding_tag_slots_stay_inactive(arrs):
    """At 3 shards the renumbered table has padding tag slots: they alias
    old tag 0's row, are zeroed in the placed poses and forced inactive,
    and every real tag comes back to its old index."""
    mesh = block_mesh(devices=["cpu"] * 3)
    t_pad = arrs.tag_poses.shape[0]
    prob = TagShardedProblem(mesh, arrs.cap_idx, arrs.tag_idx, arrs.corners,
                             arrs.block_mask, t_pad, dtype=torch.float64)
    invalid = ~prob.prep["tag_slot_valid"]
    assert invalid.any()
    poses = torch.cat(list(prob.put_tags(arrs.tag_poses))).numpy()
    active = torch.cat(list(prob.put_tag_mask(
        np.ones(t_pad, bool)))).numpy()
    assert not poses[invalid].any() and not active[invalid].any()
    np.testing.assert_array_equal(
        prob.tags_to_old(prob.put_tags(arrs.tag_poses), t_pad),
        arrs.tag_poses)
