"""The residuals' Jacobians as jets (core/jet.py), float64 on the CPU.

``torch.func.jacfwd`` is the plain version the jets are held against,
within 1e-12 relative, for the three residuals the solver differentiates:
a block's (camera, capture pose, tag pose), a localize query's (its pose)
and the capture seed's anchors' (its pose); rotations below the series
switch (``theta^2 < 1e-12``) included.  ``linearize`` is held against
the JAX package's.  A fresh process that detects, solves and localizes on
the CPU must not import ``torch._dynamo`` or sympy, which the first
``torch.func`` transform of a process imports.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from ar_slam_tpu.solve import residuals as jres
from ar_slam_tpu_torch.core import jet as J
from ar_slam_tpu_torch.core.projection import block_residual
from ar_slam_tpu_torch.core.seeding import anchor_residuals
from ar_slam_tpu_torch.solve import residuals as tres
from ar_slam_tpu_torch.solve.localize import _query_residuals
from ar_slam_tpu_torch.solve.lm import LMConfig
from torch_cases import synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635
REL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _blocks(rot: str):
    """(camera, capture poses, tag poses, corners) of every block of a
    synthetic map; ``rot`` "small" sets every rotation below the series
    switch (one exactly zero), "none" leaves them."""
    a = synthetic_arrays(seed=4, n_tags=12, n_caps=6, perturb=0.02)
    m = a.block_mask
    cam = a.camera + np.array([0.0, 0.01, -0.002])
    cap, tag = a.cap_poses[a.cap_idx[m]], a.tag_poses[a.tag_idx[m]]
    if rot == "small":
        rng = np.random.default_rng(0)
        cap[:, 3:6] = rng.normal(scale=1e-8, size=cap[:, 3:6].shape)
        tag[:, 3:6] = rng.normal(scale=1e-8, size=tag[:, 3:6].shape)
        cap[0, 3:6] = tag[1, 3:6] = 0.0
    return [torch.as_tensor(x) for x in (cam, cap, tag, a.corners[m])]


@pytest.mark.parametrize("distortion", [False, True])
@pytest.mark.parametrize("rot", ["none", "small"])
def test_block_jets_equal_jacfwd(rot, distortion):
    """A block's residual and its three Jacobian blocks: the value bit for
    bit the plain residual, the tangents jacfwd's within 1e-12."""
    cam, cap, tag, crn = _blocks(rot)
    rj = block_residual(J.variables(cam, 15), J.variables(cap, 15, 3),
                        J.variables(tag, 15, 9), crn, SIZE, distortion)
    assert torch.equal(rj.v, block_residual(cam, cap, tag, crn, SIZE,
                                            distortion))
    assert torch.isfinite(rj.d).all()
    ref = vmap(jacfwd(lambda c, p, t, o: block_residual(
        c, p, t, o, SIZE, distortion), argnums=(0, 1, 2)),
        in_dims=(None, 0, 0, 0))(cam, cap, tag, crn)
    for got, want in zip((rj.d[..., 0:3], rj.d[..., 3:9], rj.d[..., 9:15]),
                         ref):
        assert torch.isfinite(want).all()
        assert _rel(got, want) <= REL


@pytest.mark.parametrize("rot", ["none", "small"])
def test_localize_jets_equal_jacfwd(rot):
    """Localize's residual over padded queries: (Q, K*8, 6) tangents."""
    cam, cap, tag, crn = _blocks(rot)
    q, k = 4, 5
    tps = tag[:q * k].reshape(q, k, 6)
    corners = crn[:q * k].reshape(q, k, 4, 2)
    maskf = torch.ones(q, k, dtype=torch.float64)
    maskf[1, 3:] = 0.0
    pose = cap[:q * k:k]
    config = LMConfig(enable_distortion=True)
    rj = _query_residuals(cam, J.variables(pose, 6), tps, corners, maskf,
                          SIZE, config)
    assert torch.equal(rj.v, _query_residuals(cam, pose, tps, corners, maskf,
                                              SIZE, config))
    assert torch.isfinite(rj.d).all()
    for i in range(q):
        want = jacfwd(lambda p: _query_residuals(
            cam, p[None], tps[i:i + 1], corners[i:i + 1], maskf[i:i + 1],
            SIZE, config)[0])(pose[i])
        assert _rel(rj.d[i], want) <= REL
    assert not rj.d[1, 3 * 8:].any()  # padded blocks


@pytest.mark.parametrize("rot", ["none", "small"])
def test_anchor_jets_equal_jacfwd(rot):
    """The capture seed's Gauss-Newton residual over masked anchors."""
    cam, cap, tag, crn = _blocks(rot)
    s = 6
    mask = torch.tensor([True, True, False, True, True, False])
    pose = cap[0]
    args = (cam, tag[:s], crn[:s], mask, SIZE)
    rj = anchor_residuals(J.variables(pose, 6), *args)
    assert torch.equal(rj.v, anchor_residuals(pose, *args))
    assert torch.isfinite(rj.d).all()
    want = jacfwd(lambda p: anchor_residuals(p, *args))(pose)
    assert _rel(rj.d, want) <= REL


def test_jet_ops_equal_jacfwd():
    """Each jet operation with a constant operand on either side, against
    jacfwd: +, -, *, / with scalars and tensors, sqrt, sin, cos, where,
    sum, cross, cat, stack, indexing, reshape."""
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(rng.uniform(0.5, 2.0, size=(4, 3)))
    c = torch.as_tensor(rng.uniform(0.5, 2.0, size=(4, 3)))

    def f(x):
        y = (2.0 - x) * c + c / x - x / 3.0 + 1.0 / x
        y = J.where(J.value(y) > 0, J.sqrt(J.sin(y) * J.sin(y) + 1.0),
                    J.cos(y))
        z = J.cross(y, c) + J.cross(c[0], x)
        z = J.cat([z[..., :2], J.sum(z, dim=-1, keepdim=True), c[:, :1]], -1)
        return J.stack([z, -z * z], dim=0)[:, 1:].reshape((2, -1))

    got = f(J.variables(x0.reshape(-1), 12).reshape((4, 3)))
    want = jacfwd(lambda v: f(v.reshape(4, 3)))(x0.reshape(-1))
    assert torch.equal(got.v, f(x0))
    assert _rel(got.d, want) <= REL


@pytest.mark.parametrize("loss,distortion", [("trivial", False),
                                             ("huber", True)])
def test_linearize_jets_match_jax(loss, distortion):
    """``linearize`` (jets over the whole block table) against the JAX
    package's (``jax.jacfwd``), at test_torch_solve's 1e-10."""
    a = synthetic_arrays(seed=6, n_tags=16, n_caps=8, perturb=0.02)
    camera = a.camera + np.array([0.0, 0.01, -0.002])
    args = (camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx,
            a.corners, a.block_mask)
    ref = jax.jit(lambda *x: jres.linearize(*x, SIZE, distortion, loss,
                                            2.0))(*map(jnp.asarray, args))
    got = tres.linearize(*(torch.as_tensor(x) for x in args[:3]),
                         *(torch.as_tensor(x).long() for x in args[3:5]),
                         torch.as_tensor(a.corners),
                         torch.as_tensor(a.block_mask), SIZE, distortion,
                         loss, 2.0)
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-10


MAIN_PATH = """
import json, sys
import torch
torch.set_num_threads(1)
from ar_slam_tpu_torch.config import ArSlamConfig
from ar_slam_tpu_torch.detect.detect import detect_batch
from ar_slam_tpu_torch.solve.batch import solve
from ar_slam_tpu_torch.solve.localize import localize_many
from ar_slam_tpu_torch.utils.render import room_scene
from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map
frames, _ = room_scene(n_frames=2, width=320, height=240, focal=280.0)
detect_batch(frames, device="cpu")
store, _ = make_synthetic_map(n_tags=12, n_caps=6, seed=0)
out = solve(store, ArSlamConfig(), device="cpu")
loc = localize_many(store, 4, ArSlamConfig(), device="cpu")
print(json.dumps({"rmse": [out["rmse"], loc["rmse"]], "modules": {
    m: m in sys.modules for m in ("torch._dynamo", "sympy")}}))
"""


def test_main_path_imports_no_dynamo():
    """Detection, a solve and a localize in a fresh process leave
    ``torch._dynamo`` and sympy unimported."""
    p = subprocess.run([sys.executable, "-c", MAIN_PATH], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert all(r < 1.0 for r in res["rmse"]), res
    assert res["modules"] == {"torch._dynamo": False, "sympy": False}
