"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the CPU runs of the suite).  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda.py -q

Shapes are the main path's: a batch of 8 frames at 1020x768, three
threshold windows stacked on the batch axis, count-pooled 2x.
"""

import numpy as np
import pytest
import torch

from ar_slam_tpu_torch.detect import box, ccl, extract

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(n=8, h=768, w=1020, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(60, 220, size=(n, h // 16, w // 17))
    img = np.kron(base, np.ones((16, 17)))[:, :h, :w]
    img += rng.normal(scale=8.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def _planes(dev, n=8):
    imgs = torch.from_numpy(_frames(n)).to(dev)
    bins = [imgs < box.box_sum_plain(imgs, w) / float(w * w) - 7.0
            for w in (3, 13, 23)]
    b = torch.cat(bins)
    nb, h, w = b.shape
    counts = b.reshape(nb, h // 2, 2, w // 2, 2).to(torch.int32).sum((2, 4))
    return (counts >= 2).contiguous()


@pytest.mark.parametrize("win", [3, 13, 23, 11])
def test_box_kernel_matches_f64(dev, win):
    imgs = torch.from_numpy(_frames()).to(dev)
    if win == 11:  # the refine field maps: values ~1e7 per pixel
        imgs = imgs * imgs * torch.arange(1020, device=dev, dtype=torch.float32)
    got = box.box_sum_batch(imgs, win)
    ref = box.box_sum_plain(imgs.double(), win)
    plain = box.box_sum_plain(imgs, win)
    torch.cuda.synchronize()
    # float32 sums of <= 23*23 positive terms: relative error ~ taps * 2^-24
    tol = 1e-5 * ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= tol
    assert (plain.double() - ref).abs().max().item() <= tol


def test_ccl_kernel_equals_plain(dev):
    planes = _planes(dev)
    got = ccl.connected_components_batch(planes)
    torch.cuda.synchronize()
    assert torch.equal(got, ccl.connected_components_plain(planes))


def test_ccl_kernel_serpentine(dev):
    img = np.zeros((96, 96), bool)
    for i, y in enumerate(range(4, 92, 6)):
        img[y, 4:92] = True
        if y + 6 < 92:
            img[y:y + 7, 90 if i % 2 == 0 else 4] = True
    rng = np.random.default_rng(2)
    b = torch.from_numpy(np.stack([img, rng.random((96, 96)) < 0.45])).to(dev)
    assert torch.equal(ccl.connected_components_batch(b),
                       ccl.connected_components_plain(b))


def test_extract_kernel_equals_plain(dev):
    from ar_slam_tpu_torch.detect.detect import top_k_subsampled

    planes = _planes(dev)
    labels = ccl.connected_components_batch(planes)
    roots, _ = top_k_subsampled(labels, 64, 2, 0.25)
    got = extract.extreme_quads(labels, roots)
    plain = extract.extreme_quads_plain(labels, roots)
    torch.cuda.synchronize()
    # exact wherever the plain version's float32 coordinate sums are exact
    n, h, w = labels.shape
    lin = torch.arange(h * w, device=dev)
    exact = torch.ones(roots.shape, dtype=torch.bool, device=dev)
    for i in range(n):
        member = labels[i].reshape(1, -1) == roots[i][:, None]
        sx = torch.where(member, lin % w, 0).sum(1)
        sy = torch.where(member, lin // w, 0).sum(1)
        exact[i] = (sx < 2**24) & (sy < 2**24)
    assert exact.float().mean().item() > 0.9
    assert torch.equal(got[exact], plain[exact])
