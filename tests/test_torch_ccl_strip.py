"""Port parity for K3, the strip-scan CCL: the plain version of
``connected_components_strip_batch`` (the CPU branch of its wrapper)
against the reference's ``connected_components_pallas_batch`` in interpret
mode and against its XLA ``connected_components``, exactly, also where the
round cap stops the reference before its fixpoint (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.detect.pallas_ccl import connected_components_pallas_batch
from ar_slam_tpu.detect.tpu_detect import connected_components
from ar_slam_tpu_torch.detect import ccl
from torch_cases import mixed_batch, serpentine

torch.set_num_threads(1)


def _nonaligned():
    """tests/test_pallas.py:29-39: W not a multiple of 128 (the reference's
    pad + remap) and a diagonal staircase (8-connectivity)."""
    img = np.zeros((33, 97), bool)
    img[4:20, 5:60] = True
    for i in range(10):
        img[22 + i % 8, 70 + i * 2: 72 + i * 2] = True
    return img


def _xla(batch, iters):
    return np.asarray(jax.jit(jax.vmap(
        lambda b: connected_components(b, iters)))(jnp.asarray(batch)))


def _strip(batch, iters):
    got = ccl.connected_components_strip_batch(torch.from_numpy(batch), iters)
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("iters", [2, 4, 24])
def test_strip_plain_matches_pallas_interpret(iters):
    """Non-aligned blobs and a serpentine needing ~7 rounds, at caps below
    and above that: equal to the Pallas strip kernels, label for label."""
    batch = np.stack([_nonaligned(), serpentine(33, 97, pitch=4)])
    ref = np.asarray(connected_components_pallas_batch(
        jnp.asarray(batch), iters=iters, interpret=True))
    got = _strip(batch, iters)
    np.testing.assert_array_equal(got, ref)
    snake = got[1][batch[1]]
    if iters == 2:
        assert len(np.unique(snake)) > 1  # the cap cut the serpentine short
    if iters == 24:
        assert (snake == np.flatnonzero(batch[1])[0]).all()


@pytest.mark.parametrize("iters", [3, 24])
def test_strip_plain_matches_xla(iters):
    """A moderate batch (serpentine + noise, noise, blank) against the
    reference's XLA round, which scans rows forward then reverse and
    columns likewise: the same round as the strip kernels."""
    rng = np.random.default_rng(5)
    h, w = 150, 301
    snake = serpentine(h, w) | (rng.random((h, w)) < 0.05)
    batch = np.stack([snake, rng.random((h, w)) < 0.45,
                      np.zeros((h, w), bool)])
    np.testing.assert_array_equal(_strip(batch, iters), _xla(batch, iters))


def test_strip_plain_at_fixpoint_equals_uncapped():
    """Below the cap the strip labels are the fixpoint: equal to the fused
    path's plain version (no cap), which K2 matches on the card."""
    rng = np.random.default_rng(6)
    batch = rng.random((2, 64, 130)) < 0.3
    t = torch.from_numpy(batch)
    assert torch.equal(ccl.connected_components_strip_batch(t, 1000),
                       ccl.connected_components_plain(t))


@pytest.mark.parametrize("iters", [2, 24])
def test_strip_per_plane_exit_equals_batch(iters):
    """What the kernel's per-plane exit relies on: planes that stop at
    different rounds (blobs done in 2-3, a serpentine cut off by the cap,
    noise), each run on its own with its own exit, give the batch run's
    labels, and those are the Pallas strip kernels' (batch-global exit)."""
    batch = mixed_batch()
    t = torch.from_numpy(batch)
    whole = ccl.connected_components_plain(t, iters)
    alone = torch.cat([ccl.connected_components_plain(t[i:i + 1], iters)
                       for i in range(len(batch))])
    assert torch.equal(alone, whole)
    ref = connected_components_pallas_batch(jnp.asarray(batch), iters=iters,
                                            interpret=True)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(ref))
    assert torch.equal(ccl.connected_components_plain(t[:1], 3),
                       ccl.connected_components_plain(t[:1]))
    assert len(np.unique(whole[1].numpy()[batch[1]])) > 1
