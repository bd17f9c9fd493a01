"""Port parity: core/lie, core/projection and core/seeding against the JAX
package, float64 on the CPU (inputs from a seeded numpy generator)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.core import lie as jlie
from ar_slam_tpu.core import projection as jproj
from ar_slam_tpu.core import seeding as jseed
from ar_slam_tpu_torch.core import lie as tlie
from ar_slam_tpu_torch.core import projection as tproj
from ar_slam_tpu_torch.core import seeding as tseed

torch.set_num_threads(1)
RTOL = 1e-12
SIZE = 0.0635


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, ref, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _axis_angles(rng, n=40):
    aa = rng.normal(size=(n, 3))
    aa[0] = 0.0  # exactly zero
    aa[1] = [1e-9, -2e-9, 5e-10]  # series branch
    aa[2] = [3e-6, 0.0, 0.0]  # closed form just past the switch
    aa[3] = [np.pi - 1e-6, 0.0, 0.0]  # near pi
    return aa


@pytest.mark.parametrize("fn", ["axis_angle_rotate", "compose_axis_angle"])
def test_lie_binary_ops(fn):
    rng = np.random.default_rng(0)
    aa = _axis_angles(rng)
    other = rng.normal(size=aa.shape)
    if fn == "compose_axis_angle":
        other[:4] = 0.0
    ref = jax.jit(jax.vmap(getattr(jlie, fn)))(jnp.asarray(aa),
                                               jnp.asarray(other))
    _close(getattr(tlie, fn)(_t(aa), _t(other)), ref)


@pytest.mark.parametrize("fn", ["axis_angle_to_quaternion",
                                "axis_angle_to_matrix", "invert_axis_angle"])
def test_lie_unary_ops(fn):
    aa = _axis_angles(np.random.default_rng(1))
    ref = jax.jit(jax.vmap(getattr(jlie, fn)))(jnp.asarray(aa))
    _close(getattr(tlie, fn)(_t(aa)), ref)


def test_quaternion_and_matrix_round_trips():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(40, 4))
    q[0] = [1.0, 0, 0, 0]
    q[1] = [-1.0, 1e-8, 0, 0]
    q[2] = [-0.3, 0.5, 0.1, -0.2]  # w < 0 hemisphere flip
    _close(tlie.quaternion_to_axis_angle(_t(q)),
           jax.jit(jax.vmap(jlie.quaternion_to_axis_angle))(jnp.asarray(q)))
    m = np.asarray(jax.jit(jax.vmap(jlie.axis_angle_to_matrix))(
        jnp.asarray(_axis_angles(rng))))
    _close(tlie.matrix_to_axis_angle(_t(m)),
           jax.jit(jax.vmap(jlie.matrix_to_axis_angle))(jnp.asarray(m)), atol=1e-12)
    ang = rng.uniform(-20, 20, size=50)
    _close(tlie.normalize_angle(_t(ang)), jlie.normalize_angle(
        jnp.asarray(ang)))


def test_rotate_jacobian_at_zero_is_finite_and_matches():
    """Forward-mode derivatives through the theta -> 0 series branch."""
    p = np.array([0.3, -1.2, 2.0])
    for aa in (np.zeros(3), np.array([1e-9, 0.0, -1e-9])):
        ref = jax.jit(jax.jacfwd(jlie.axis_angle_rotate))(jnp.asarray(aa),
                                                          jnp.asarray(p))
        got = torch.func.jacfwd(tlie.axis_angle_rotate)(_t(aa), _t(p))
        assert torch.isfinite(got).all()
        _close(got, ref)


@pytest.mark.parametrize("distortion", [False, True])
def test_project_and_block_residual(distortion):
    rng = np.random.default_rng(3)
    cam = np.array([2800.0, 0.02, -0.003])
    cap = rng.normal(scale=0.3, size=(30, 6))
    cap[:, 2] -= 2.0
    tag = rng.normal(scale=0.3, size=(30, 6))
    obs = rng.normal(scale=200.0, size=(30, 4, 2))
    ref = jax.jit(jax.vmap(lambda c, t, o: jproj.block_residual(
        jnp.asarray(cam), c, t, o, SIZE, distortion)))(
        jnp.asarray(cap), jnp.asarray(tag), jnp.asarray(obs))
    got = tproj.block_residual(_t(cam), _t(cap), _t(tag), _t(obs), SIZE,
                               distortion)
    _close(got, ref, atol=1e-9)
    ref_c = jax.jit(lambda c, t: jproj.project_corners(
        jnp.asarray(cam), c, t, SIZE, distortion))(jnp.asarray(cap[0]),
                                                   jnp.asarray(tag[0]))
    _close(tproj.project_corners(_t(cam), _t(cap[0]), _t(tag[0]), SIZE,
                                 distortion), ref_c, atol=1e-9)


def test_reprojection_residuals():
    """The batched residuals over a padded block table, masked rows zero."""
    rng = np.random.default_rng(5)
    cam = np.array([2900.0, 0.0, 0.0])
    caps = rng.normal(scale=0.3, size=(6, 6))
    caps[:, 2] -= 2.0
    tags = rng.normal(scale=0.3, size=(9, 6))
    blocks = dict(cap_idx=rng.integers(0, 6, size=40),
                  tag_idx=rng.integers(0, 9, size=40),
                  corners=rng.normal(scale=200.0, size=(40, 4, 2)),
                  mask=rng.random(40) < 0.7)
    ref = jax.jit(lambda c, p, t, b: jproj.reprojection_residuals(
        c, p, t, b, SIZE))(jnp.asarray(cam), jnp.asarray(caps),
                           jnp.asarray(tags),
                           {k: jnp.asarray(v) for k, v in blocks.items()})
    got = tproj.reprojection_residuals(
        _t(cam), _t(caps), _t(tags),
        {k: torch.as_tensor(v) if v.dtype.kind in "bi" else _t(v)
         for k, v in blocks.items()}, SIZE)
    assert got.shape == (40, 8)
    assert not got[~torch.as_tensor(blocks["mask"])].any()
    _close(got, ref, atol=1e-9)


def _views(seed, n):
    """Tag rects seen by a capture with a known pose (+ small noise)."""
    rng = np.random.default_rng(seed)
    cam = np.array([3000.0, 0.0, 0.0])
    cap = np.array([0.05, -0.1, 1.5, 0.1, -0.2, 0.05])
    tags = np.concatenate([rng.normal(scale=0.3, size=(n, 3)),
                           rng.normal(scale=0.4, size=(n, 3))], axis=1)
    tags[:, 2] = rng.normal(scale=0.1, size=n)
    obs = np.asarray(jax.jit(jax.vmap(lambda t: jproj.project_corners(
        jnp.asarray(cam), jnp.asarray(cap), t, SIZE)))(jnp.asarray(tags)))
    return cam, cap, tags, obs + rng.normal(scale=0.3, size=obs.shape)


@pytest.mark.parametrize("mode", ["hybrid", "frontal"])
def test_seed_tag_and_capture_pose(mode):
    cam, cap, tags, obs = _views(4, 12)
    ref = jax.jit(jax.vmap(lambda o: jseed.seed_tag_pose(
        o, jnp.asarray(cam), jnp.asarray(cap), SIZE, mode)))(
        jnp.asarray(obs))
    _close(tseed.seed_tag_pose(_t(obs), _t(cam), _t(cap), SIZE, mode), ref,
           rtol=1e-10, atol=1e-12)
    ref = jax.jit(jax.vmap(lambda o, t: jseed.seed_capture_pose(
        o, jnp.asarray(cam), t, SIZE, mode)))(jnp.asarray(obs),
                                              jnp.asarray(tags))
    _close(tseed.seed_capture_pose(_t(obs), _t(cam), _t(tags), SIZE, mode),
           ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n_valid", [1, 4])
def test_seed_capture_pose_multi(n_valid):
    cam, _, tags, obs = _views(5, 6)
    mask = np.arange(6) < n_valid
    ref = jax.jit(lambda o, c, t, m: jseed.seed_capture_pose_multi(
        o, c, t, m, SIZE))(jnp.asarray(obs), jnp.asarray(cam),
                           jnp.asarray(tags), jnp.asarray(mask))
    got = tseed.seed_capture_pose_multi(_t(obs), _t(cam), _t(tags),
                                        torch.as_tensor(mask), SIZE)
    _close(got, ref, rtol=1e-9, atol=1e-11)
