"""Port parity: solve/residuals, solve/schur, solve/lm and the map.yaml
writer against the JAX package, float64 on the CPU (solve/batch is in
test_torch_batch.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.graph.arrays import export_arrays
from ar_slam_tpu.graph.yamlio import dumps_yaml as j_dumps
from ar_slam_tpu.solve import lm as jlm
from ar_slam_tpu.solve import residuals as jres
from ar_slam_tpu.solve import schur as jschur
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.convert import arrays_from_numpy, store_from_jax
from ar_slam_tpu_torch.graph.yamlio import dumps_yaml as t_dumps
from ar_slam_tpu_torch.solve import lm as tlm
from ar_slam_tpu_torch.solve import residuals as tres
from ar_slam_tpu_torch.solve import schur as tschur

torch.set_num_threads(1)
SIZE = 0.0635


def _problem(seed=3, n_tags=20, n_caps=10, perturb=0.01):
    """A synthetic map near its truth, as numpy BlockArrays."""
    store, truth = make_synthetic_map(n_tags=n_tags, n_caps=n_caps,
                                      seed=seed, noise_px=0.3)
    arrs = export_arrays(store, dtype=np.float64)
    rng = np.random.default_rng(seed)
    cap = np.zeros_like(arrs.cap_poses)
    tag = np.zeros_like(arrs.tag_poses)
    for c in store.captures:
        cap[c.index] = truth["cap_poses"][int(c.uid.split("_")[1])]
    for t in store.arucos:
        tag[t.index] = truth["tag_poses"][int(t.id.split("_")[-1])]
    cap += rng.normal(scale=perturb, size=cap.shape)
    tag += rng.normal(scale=perturb, size=tag.shape)
    return arrs._replace(cap_poses=cap, tag_poses=tag)


def _slots(arrs):
    def bound(idx):
        return int(-(-np.bincount(idx[arrs.block_mask]).max() // 8) * 8)

    return bound(arrs.tag_idx), bound(arrs.cap_idx)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("loss,distortion", [("trivial", False),
                                             ("huber", True)])
def test_linearize_matches(loss, distortion):
    a = _problem()
    camera = a.camera + np.array([0.0, 0.01, -0.002])
    args = (camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx,
            a.corners, a.block_mask)
    ref = jax.jit(lambda *x: jres.linearize(*x, SIZE, distortion, loss,
                                            2.0))(*map(jnp.asarray, args))
    t = arrays_from_numpy(a, "cpu", torch.float64)
    got = tres.linearize(torch.tensor(camera), t["cap_poses"],
                         t["tag_poses"], t["cap_idx"], t["tag_idx"],
                         t["corners"], t["block_mask"], SIZE, distortion,
                         loss, 2.0)
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-10
    cost = tres.total_cost(torch.tensor(camera), t["cap_poses"],
                           t["tag_poses"], t["cap_idx"], t["tag_idx"],
                           t["corners"], t["block_mask"], SIZE, distortion,
                           loss, 2.0)
    ref_cost = jax.jit(lambda *x: jres.total_cost(*x, SIZE, distortion, loss,
                                                  2.0))(*map(jnp.asarray,
                                                             args))
    assert abs(float(cost) - float(ref_cost)) <= 1e-10 * float(ref_cost)


def test_spd_inv_and_grouping_match():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(16, 6, 6))
    spd = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(6)
    assert _rel(tschur.spd_inv(torch.tensor(spd), 6),
                jax.jit(lambda x: jschur.spd_inv(x, 6))(jnp.asarray(spd))
                ) < 1e-10
    tag_idx = rng.integers(0, 7, size=50)
    mask = rng.random(50) < 0.8
    g, gm = tschur.group_blocks_by_tag(torch.as_tensor(tag_idx),
                                       torch.as_tensor(mask), 7, 16)
    rg, rgm = jschur.group_blocks_by_tag(jnp.asarray(tag_idx),
                                         jnp.asarray(mask), 7, 16)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rgm))
    np.testing.assert_array_equal(g.numpy()[gm.numpy()],
                                  np.asarray(rg)[np.asarray(rgm)])


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_assemble_and_schur_solve_grouped_match(lam):
    a = _problem(seed=4)
    s_tag, s_cap = _slots(a)
    n_caps, n_tags = a.cap_poses.shape[0], a.tag_poses.shape[0]
    cap_act = a.cap_mask.copy()
    cap_act[0] = False  # one frozen capture exercises the masks

    def jax_side(cam, cp, tp, ci, ti, crn, bm, ca, ta):
        lin, qual, ctx = jlm.make_grouped_hooks(ci, ti, crn, bm, SIZE,
                                                n_caps, n_tags, s_tag, s_cap)
        eqs, cost = lin(cam, cp, tp)
        d = jschur.schur_solve_grouped(eqs, ctx[0], lam, True, ca, ta)
        return eqs, cost, d

    eqs_r, cost_r, d_r = jax.jit(jax_side)(*map(jnp.asarray, (
        a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx, a.corners,
        a.block_mask, cap_act, a.tag_mask)))
    t = arrays_from_numpy(a, "cpu", torch.float64)
    lin, _, (slot_cap, *_) = tlm.make_grouped_hooks(
        t["cap_idx"], t["tag_idx"], t["corners"], t["block_mask"], SIZE,
        n_caps, n_tags, s_tag, s_cap)
    eqs, cost = lin(t["camera"], t["cap_poses"], t["tag_poses"])
    d = tschur.schur_solve_grouped(eqs, slot_cap, lam, True,
                                   torch.as_tensor(cap_act), t["tag_mask"])
    assert abs(float(cost) - float(cost_r)) <= 1e-12 * float(cost_r)
    for name in eqs._fields:
        assert _rel(getattr(eqs, name), getattr(eqs_r, name)) < 1e-9, name
    for g, r in zip(d, d_r):
        assert _rel(g, r) < 1e-9


def test_lm_solve_matches():
    a = _problem(seed=3)
    s_tag, s_cap = _slots(a)
    args = (a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx,
            a.corners, a.block_mask, True, a.cap_mask, a.tag_mask)
    ref = jlm.lm_solve(*map(jnp.asarray, args), aruco_size=SIZE,
                       obs_per_tag=s_tag, obs_per_cap=s_cap)
    t = arrays_from_numpy(a, "cpu", torch.float64)
    got = tlm.lm_solve(t["camera"], t["cap_poses"], t["tag_poses"],
                       t["cap_idx"], t["tag_idx"], t["corners"],
                       t["block_mask"], True, t["cap_mask"], t["tag_mask"],
                       aruco_size=SIZE, obs_per_tag=s_tag, obs_per_cap=s_cap)
    c_ref, c_got = float(ref[3]["cost"]), float(got[3]["cost"])
    assert abs(c_got - c_ref) <= 1e-8 * c_ref
    assert got[3]["iterations"] == int(ref[3]["iterations"])
    assert int(got[3]["termination"]) == int(ref[3]["termination"])
    assert float(got[3]["initial_cost"]) > 10 * c_got


def test_dumps_yaml_identical_text():
    js, _ = make_synthetic_map(n_tags=9, n_caps=4, seed=1)
    for cap in js.captures:
        cap.inv_pose[:] = np.arange(6) * 0.1 + cap.index
    for tag in js.arucos:
        tag.pose[:] = np.linspace(-1, 1, 6) / (tag.index + 1)
    assert t_dumps(store_from_jax(js)) == j_dumps(js)
