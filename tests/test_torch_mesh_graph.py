"""The mesh path's program stages on the CPU, float64.

parallel/dist_lm.py runs the tag-sharded LM as the stages ``setup`` /
``step`` / ``accept`` / ``reject`` (``lm.lm_step`` over the fused
quality) and a flush's seeds as one stage ``seed``
(``seed_waves_sharded``), which a mesh whose shards share one card
replays as CUDA graphs.  Here the same stages run eagerly
(``graphs=False``, as the CPU always runs them) over ``[cpu] * k``: they
give the plain loop's (``_lm_sharded``: ``lm_core`` over the same hooks)
results bit for bit, with the same count of packed reductions; they agree
with the JAX package's ``lm_solve_dist`` and ``apply_wave_seeds`` within
1e-10; the seeds are bit for bit the same at every k; no stage reads the
host; and ``solve`` over a mesh, its flushes carrying several waves,
agrees with the JAX package's single-device ``solve`` (the JAX mesh's
wave programs are not called, ROADMAP Queue 3).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.parallel import block_mesh as j_block_mesh
from ar_slam_tpu.parallel import lm_solve_dist as j_lm_solve_dist
from ar_slam_tpu.solve import batch as jbatch
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.graph.arrays import obs_bucket
from ar_slam_tpu_torch.parallel import block_mesh, dist_lm
from ar_slam_tpu_torch.parallel.mesh import Mesh
from ar_slam_tpu_torch.solve import batch as tbatch
from ar_slam_tpu_torch.solve import graphs
from ar_slam_tpu_torch.solve.lm import LMConfig
from test_torch_lm_graph import CASES, NoHostSync
from torch_cases import bfs_waves, synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635


@pytest.fixture(scope="module")
def arrs():
    return synthetic_arrays(seed=3, n_tags=20, n_caps=10, perturb=0.01)


def _placed(a, k, case="function"):
    """(problem, placed LM arguments, keywords) of a case on ``[cpu] * k``
    (masks as test_torch_lm_graph's cases set them)."""
    mesh = block_mesh(devices=["cpu"] * k)
    prob = dist_lm.TagShardedProblem(mesh, a.cap_idx, a.tag_idx, a.corners,
                                     a.block_mask, a.tag_poses.shape[0],
                                     dtype=torch.float64)
    cam, cap_m, tag_m, kw = True, a.cap_mask, a.tag_mask, {}
    if case == "warmup_masks":  # register-then-refine: camera frozen
        cam = False
        cap_m = a.cap_mask & (np.arange(a.cap_mask.size) % 3 == 0)
        tag_m = a.tag_mask & (np.arange(a.tag_mask.size) % 2 == 0)
    if case == "budget_1":
        kw["iter_budget"] = 1
    if case == "disabled":
        kw["enabled"] = False
    camera, caps, cam_a, cap_a = prob.put_rep(a.camera, a.cap_poses,
                                              np.asarray(cam), cap_m)
    args = (camera, caps, prob.put_tags(a.tag_poses),
            prob.block_mask(a.block_mask), cam_a, cap_a,
            prob.put_tag_mask(tag_m))
    return prob, args, kw


def _equal(got, ref):
    """Two (camera, caps, tags, info) results are the same bit for bit."""
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert len(got[2]) == len(ref[2])
    assert all(torch.equal(g, r) for g, r in zip(got[2], ref[2]))
    for key, r in ref[3].items():
        g = got[3][key]
        assert (torch.equal(g, r) if isinstance(r, torch.Tensor)
                else g == r), key


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("case", list(CASES))
def test_staged_mesh_lm_equals_lm_core(arrs, case, solver, k):
    """The stages driven by their host loop give ``lm_core``'s results
    over the same tag-sharded hooks bit for bit (state, cost, lambda, nu,
    flags, termination, iterations, gradient) and run as many packed
    reductions, through every termination."""
    overrides, term = CASES[case]
    config = LMConfig(linear_solver=solver, **overrides)
    prob, args, kw = _placed(arrs, k, case)
    ref = dist_lm._lm_sharded(prob, SIZE, config, *args, **kw)
    plain = prob.mesh.reductions
    got = dist_lm.lm_solve_sharded(prob, SIZE, config, *args, graphs=False,
                                   **kw)
    _equal(got, ref)
    assert prob.mesh.reductions == 2 * plain
    if term is not None:
        assert int(got[3]["termination"]) == term
    iters = got[3]["iterations"]
    assert iters == {"budget_1": 1, "full_budget": 6, "disabled": 0,
                     "gradient_at_start": 0}.get(case, iters)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_staged_mesh_lm_matches_jax(arrs, solver, k):
    """``lm_solve_dist`` (the stages, eagerly) against the JAX package's
    jitted ``lm_solve_dist`` on a k-device mesh: the same iterations and
    termination, cost within 1e-10 relative, poses within 1e-10 (CG
    solved to 1e-10 in up to 100 steps, where its inexact steps would
    otherwise follow rounding; measured: 5e-11)."""
    config = dict(max_iterations=10, linear_solver=solver,
                  cg_tolerance=1e-10, cg_max_iterations=100)
    a = arrs
    ref = j_lm_solve_dist(
        j_block_mesh(k), a.camera, a.cap_poses, a.tag_poses, a.cap_idx,
        a.tag_idx, a.corners, a.block_mask, np.asarray(True), a.cap_mask,
        a.tag_mask, aruco_size=SIZE, config=LMConfig(**config))
    got = dist_lm.lm_solve_dist(
        block_mesh(devices=["cpu"] * k), a.camera, a.cap_poses, a.tag_poses,
        a.cap_idx, a.tag_idx, a.corners, a.block_mask, True, a.cap_mask,
        a.tag_mask, aruco_size=SIZE, config=LMConfig(**config),
        graphs=False)
    assert got[3]["iterations"] == int(ref[3]["iterations"])
    assert int(got[3]["termination"]) == int(ref[3]["termination"])
    c_ref = float(ref[3]["cost"])
    assert abs(float(got[3]["cost"]) - c_ref) <= 1e-10 * c_ref
    for g, r in zip(got[:3], ref[:3]):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-10


def _seed_case(k, single=False, order=(3, 1, 5)):
    """(arrays, waves in the store's numbering, slots, problem on
    ``[cpu] * k``, the mesh's seed solver)."""
    a = synthetic_arrays(seed=7, n_tags=40, n_caps=10, perturb=0.05)
    waves = bfs_waves(a, list(order), single)
    slots = obs_bucket(int(np.bincount(a.cap_idx[a.block_mask]).max()))
    prob = dist_lm.TagShardedProblem(
        block_mesh(devices=["cpu"] * k), a.cap_idx, a.tag_idx, a.corners,
        a.block_mask, a.tag_poses.shape[0], dtype=torch.float64)
    solver = dist_lm.make_dist_wave_solver(
        prob, aruco_size=SIZE, config=LMConfig(),
        seed_mode="frontal" if single else "hybrid", graphs=False)
    return a, waves, slots, prob, solver


def _seeded(k, single=False, w_min=1):
    """The mesh's seeds of three BFS waves: (caps, tags in the store's
    numbering, tags in the renumbered order, the problem, the reductions
    they ran)."""
    a, waves, slots, prob, solver = _seed_case(k, single)
    camera, caps = prob.put_rep(a.camera, a.cap_poses)
    out = solver.seed_waves(camera, caps, prob.put_tags(a.tag_poses), waves,
                            slots=slots, w_min=w_min)
    return (out[0], prob.tags_to_old(out[1], a.tag_poses.shape[0]),
            torch.cat(list(out[1])), prob, prob.mesh.reductions)


@pytest.mark.parametrize("mode,single", [("hybrid", False),
                                         ("frontal", True)])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_mesh_seed_stage_matches_jax(k, mode, single):
    """The ``seed`` stage over three waves (padded to W = 4, one padding
    wave) against the JAX package's ``apply_wave_seeds``, wave after
    wave, on the repacked table (renumbered tags, repacked rows): within
    1e-10; one packed reduction a wave."""
    a, waves, slots, prob, _ = _seed_case(k, single)
    caps, _, tags_new, _, reductions = _seeded(k, single)
    assert reductions == 4
    p = prob.prep
    cat = [torch.cat(list(x)).numpy() for x in (prob.cap_idx, prob.tag_idx,
                                                prob.corners)]
    ref_caps = jnp.asarray(a.cap_poses)
    ref_tags = jnp.asarray(torch.cat(list(prob.put_tags(a.tag_poses)))
                           .numpy())
    fn = jax.jit(partial(jbatch.apply_wave_seeds, aruco_size=SIZE,
                         seed_mode=mode))
    for seed_cap, seed_row, rows, tags, anchors in waves:
        init = np.full(p["t_new"], -1)
        init[p["tag_inv"][tags]] = p["row_of_block"][rows]
        anc = np.zeros(slots, np.int64)
        anc[:len(anchors)] = p["row_of_block"][anchors]
        ref_caps, ref_tags = fn(
            jnp.asarray(a.camera), ref_caps, ref_tags, *map(jnp.asarray, cat),
            jnp.asarray(seed_cap),
            jnp.asarray(p["row_of_block"][seed_row] if seed_row >= 0 else -1),
            jnp.asarray(init), jnp.asarray(anc),
            jnp.asarray(np.arange(slots) < len(anchors)))
    for g, r in ((caps, ref_caps), (tags_new, ref_tags)):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-10
    assert not np.array_equal(caps.numpy(), a.cap_poses)


@pytest.mark.parametrize("single", [False, True])
def test_mesh_seed_stage_same_at_every_k(single):
    """The seeds in the store's numbering are bit for bit the same over
    1, 2 and 3 shards (and with the tables padded to W = 8), and within
    1e-12 of the single-device stage's (``batch.seed_waves``, whose
    masked anchor slots hold other values)."""
    runs = [_seeded(k, single)[:2] for k in (1, 2, 3)]
    runs.append(_seeded(2, single, w_min=8)[:2])
    for caps, tags in runs[1:]:
        assert torch.equal(caps, runs[0][0])
        assert np.array_equal(tags, runs[0][1])
    a, waves, slots, _, _ = _seed_case(1, single)
    t = {k: torch.as_tensor(getattr(a, k)) for k in (
        "camera", "cap_poses", "tag_poses", "corners")}
    ref = tbatch.seed_waves(
        t["camera"], t["cap_poses"], t["tag_poses"],
        torch.as_tensor(a.tag_idx).long(), t["corners"],
        torch.as_tensor(tbatch.pack_waves(waves, slots)), aruco_size=SIZE,
        seed_mode="frontal" if single else "hybrid")
    assert np.abs(runs[0][0].numpy() - ref[0].numpy()).max() <= 1e-12
    assert np.abs(runs[0][1] - ref[1].numpy()).max() <= 1e-12


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_mesh_stages_read_nothing_back(arrs, monkeypatch, solver):
    """No mesh stage (setup, step, accept, reject, seed) reads a value to
    the host or makes a tensor from host data: each runs under
    NoHostSync, the host loop between them does not."""
    ran = []
    run = graphs.Program.run

    def guarded(self, name):
        ran.append(name)
        with NoHostSync():
            run(self, name)

    monkeypatch.setattr(graphs.Program, "run", guarded)
    for case in ("function", "stall", "warmup_masks"):
        config = LMConfig(linear_solver=solver, **CASES[case][0])
        prob, args, kw = _placed(arrs, 3, case)
        dist_lm.lm_solve_sharded(prob, SIZE, config, *args, graphs=False,
                                 **kw)
    _seeded(3)
    assert {"setup", "step", "accept", "reject", "seed"} <= set(ran)


def test_graphed_mesh_is_a_rule_of_layout():
    """Graphs need a CUDA mesh and ``graphs``: shards on one card
    (``[cuda:0] * k``) and shards spread over cards (``[cuda:0,
    cuda:1]``, one graph a stage spanning them) replay them; the CPU and
    ``graphs=False`` run the stages eagerly."""
    one = Mesh([torch.device("cuda", 0)] * 3)
    spread = Mesh(["cuda:0", "cuda:1"])
    assert dist_lm.graphed_mesh(one) and dist_lm.graphed_mesh(
        Mesh([torch.device("cuda", 1)]))
    assert dist_lm.graphed_mesh(spread)
    assert not dist_lm.graphed_mesh(one, graphs=False)
    assert not dist_lm.graphed_mesh(spread, graphs=False)
    assert not dist_lm.graphed_mesh(Mesh(["cpu"] * 2))


def _solver(config, **fields):
    return dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, **fields))


def _poses(store):
    return (np.stack([c.inv_pose for c in store.captures]),
            np.stack([t.pose for t in store.arucos]), store.camera.params)


@pytest.mark.parametrize("fields,k", [
    (dict(optimize_every=3), 2),
    (dict(optimize_every=2, seed_anchors="single"), 3)])
def test_mesh_solve_multi_wave_flushes_match_jax(fields, k):
    """``solve`` on ``[cpu] * k`` whose flushes carry several waves (the
    mesh's seed tables padded to the optimize_every bucket) against the
    JAX package's single-device ``solve`` at the parity tests' 1e-6, and
    the port's single-device ``solve``."""
    js, _ = make_synthetic_map(n_tags=16, n_caps=8, seed=3, noise_px=0.3)
    ts, single = store_from_jax(js), store_from_jax(js)
    ref = jbatch.solve(js, _solver(JConfig(), **fields), dtype=np.float64)
    cfg = _solver(TConfig(), **fields)
    got = tbatch.solve(ts, cfg, dtype=torch.float64,
                       mesh=block_mesh(devices=["cpu"] * k), graphs=False)
    one = tbatch.solve(single, cfg, dtype=torch.float64, device="cpu")
    assert got["waves"] == ref["waves"] == 8 and got["rmse"] < 0.5
    for other, tol in ((ref, 1e-6), (one, 1e-6)):
        assert abs(got["rmse"] - other["rmse"]) <= tol * other["rmse"]
    for g, r, o in zip(_poses(ts), _poses(js), _poses(single)):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, o, rtol=1e-6, atol=1e-6)
