"""The port's CUDA kernels against their plain PyTorch versions, and the
CG solver's host-read-free steps against the CPU, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the CPU runs of the suite).  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda.py -q

Shapes are the main paths': a batch of 8 frames at 1020x768 (K1, K2,
K4), or decimated 12 MP planes (K3), three threshold windows stacked on
the batch axis, count-pooled 2x.
"""

import numpy as np
import pytest
import torch

from ar_slam_tpu_torch.detect import box, ccl, extract
from torch_cases import cap_planes, extract_cases, mixed_batch, serpentine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(n=8, h=768, w=1020, seed=0):
    """(n, h, w) uint8 frames: flat patches of 16x17 pixels plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(60, 220, size=(n, -(-h // 16), -(-w // 17)))
    img = np.kron(base, np.ones((16, 17)))[:, :h, :w]
    img += rng.normal(scale=8.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _planes(dev, n=8):
    frames = torch.from_numpy(_frames(n)).to(dev)
    return box.threshold_plain(frames, (3, 13, 23), 7.0, 2)


@pytest.mark.parametrize("win", [3, 13, 23, 11])
def test_box_kernel_matches_f64(dev, win):
    """Bit for bit the plain version (the same direct sums in the same
    order), and within float32 rounding of a float64 sum."""
    imgs = torch.from_numpy(_frames()).to(dev, torch.float32)
    if win == 11:  # the refine field maps: values ~1e7 per pixel
        imgs = imgs * imgs * torch.arange(1020, device=dev, dtype=torch.float32)
    got = box.box_sum_batch(imgs, win)
    ref = box.box_sum_plain(imgs.double(), win)
    plain = box.box_sum_plain(imgs, win)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    # float32 sums of <= 23*23 positive terms: relative error ~ taps * 2^-24
    tol = 1e-5 * ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("shape", [(8, 768, 1020), (2, 3024, 4032),
                                   (3, 37, 141), (1, 65, 257)])
def test_threshold_kernel_equals_plain(dev, shape):
    """One launch for every window: bool for bool the plain version on
    room-16 and 12 MP frames and on sizes with partial tiles and partial
    2x2 blocks; also at decimation 1 and 3 and a single window."""
    frames = torch.from_numpy(_frames(*shape)).to(dev)
    for windows, d in (((3, 13, 23), 2), ((23,), 1), ((5, 11), 3)):
        before = box.threshold_launches
        got = box.threshold_batch(frames, windows, 7.0, d)
        assert box.threshold_launches == before + 1
        plain = box.threshold_plain(frames, windows, 7.0, d)
        torch.cuda.synchronize()
        assert got.shape == plain.shape and torch.equal(got, plain)


def _k2_equal(b, iters):
    """K2 on a batch equals the plain transcription, labels and rounds."""
    got = ccl.connected_components_batch(b.contiguous(), iters)
    rounds = ccl.fused_plane_rounds()
    plain = [ccl.fused_plane_plain(p, iters) for p in b]
    assert torch.equal(got, torch.stack([lab for lab, _ in plain]))
    assert rounds == [r for _, r in plain]
    return got, rounds


def test_ccl_kernel_equals_plain(dev):
    """Room-16's planes (24 of 384x510) at the cap of 24."""
    _k2_equal(_planes(dev), 24)


@pytest.mark.parametrize("iters", [2, 24])
def test_ccl_kernel_serpentine(dev, iters):
    """A serpentine the cap cuts short, 45 % noise and the serpentine with
    5 % noise: equal to the Gauss-Seidel plain version under the cap."""
    b = torch.from_numpy(cap_planes()).to(dev)
    got, rounds = _k2_equal(b, iters)
    assert rounds[0] == iters
    assert torch.unique(got[0][b[0]]).numel() > 1


@pytest.mark.parametrize("iters", [2, 24])
def test_ccl_kernel_mixed_batch(dev, iters):
    """Planes that stop at different rounds in one launch."""
    b = torch.from_numpy(mixed_batch()).to(dev)
    _, rounds = _k2_equal(b, iters)
    assert iters < 3 or rounds[0] < rounds[1] == iters


def test_ccl_kernel_near_pixel_limit(dev):
    """(8, 896, 1024): just under FUSED_CCL_PIXEL_LIMIT, 14 strips on a
    cluster of 8 CTAs, several cluster summary steps per column stage."""
    rng = np.random.default_rng(5)
    base = rng.uniform(60, 220, size=(8, 896 // 16, 1024 // 16))
    b = torch.from_numpy(np.kron(base, np.ones((16, 16))) < 120).to(dev)
    b |= torch.from_numpy(rng.random(b.shape) < 0.05).to(dev)
    _k2_equal(b, 24)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 77), (77, 1), (64, 128),
                                 (65, 129), (3000, 40), (9, 8192)])
def test_ccl_kernel_shapes(dev, h, w):
    """A single row, column and pixel, one full strip and column group, one
    row and column beyond them, 47 strips, and the widest plane."""
    rng = np.random.default_rng(h * 7 + w)
    b = torch.from_numpy(np.stack([rng.random((h, w)) < 0.45,
                                   rng.random((h, w)) < 0.1])).to(dev)
    _k2_equal(b, 24)


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


@pytest.mark.parametrize("iters", [2, 24])
def test_ccl_strip_kernel_serpentine_at_cap(dev, iters):
    """A serpentine needing ~h/6 rounds, cut short by the cap, next to a
    noise plane, at a non-aligned width: equal to the plain version label
    for label (a Gauss-Seidel round would run ahead of it)."""
    rng = np.random.default_rng(3)
    b = torch.from_numpy(np.stack([serpentine(301, 517),
                                   rng.random((301, 517)) < 0.45])).to(dev)
    got = ccl.connected_components_strip_batch(b, iters)
    torch.cuda.synchronize()
    assert ccl.strip_rounds() == iters
    assert torch.equal(got, ccl.connected_components_plain(b, iters))
    assert torch.unique(got[0][b[0]]).numel() > 1


def test_ccl_strip_kernel_12mp_planes(dev):
    """Decimated 12 MP planes (1512x2016): equal to the plain version and,
    once converged below the cap, to the fixpoint."""
    rng = np.random.default_rng(4)
    base = rng.uniform(60, 220, size=(2, 1512 // 24, 2016 // 24))
    b = torch.from_numpy(np.kron(base, np.ones((24, 24))) < 120).to(dev)
    b |= torch.from_numpy(rng.random(b.shape) < 0.05).to(dev)
    got = ccl.connected_components_strip_batch(b.contiguous(), 24)
    torch.cuda.synchronize()
    assert torch.equal(got, ccl.connected_components_plain(b, 24))
    if ccl.strip_rounds() < 24:  # K2 with a cap no plane reaches
        assert torch.equal(got, ccl.connected_components_batch(
            b.contiguous(), b[0].numel()))


@pytest.mark.parametrize("iters", [1, 2, 24])
def test_ccl_strip_kernel_mixed_batch(dev, iters):
    """Planes that stop at different rounds in one launch: each plane's own
    exit on the card gives the plain version's batch labels, and the rounds
    each plane ran are the plain version's."""
    batch = mixed_batch()
    b = torch.from_numpy(batch).to(dev)
    got = ccl.connected_components_strip_batch(b, iters)
    rounds, converged = ccl.strip_plane_rounds()
    assert torch.equal(got, ccl.connected_components_plain(b, iters))
    for i in range(len(batch)):
        plane = b[i:i + 1]
        done = [r for r in range(1, iters + 1) if torch.equal(
            ccl.connected_components_plain(plane, r - 1),
            ccl.connected_components_plain(plane, r))]
        assert converged[i] == bool(done)
        assert rounds[i] == (done[0] if done else iters)
    assert not converged[1] and (iters < 3 or converged[0])


@pytest.mark.parametrize("h,w", [(1, 1), (1, 77), (77, 1), (45, 33),
                                 (301, 517), (3500, 40), (2, 8000)])
def test_ccl_strip_kernel_shapes(dev, h, w):
    """Widths that are not a multiple of 32, a single row and column, a
    plane too tall for a 16-column strip in shared memory and one too wide
    for 8 rows a block."""
    rng = np.random.default_rng(h * 7 + w)
    b = torch.from_numpy(np.stack([rng.random((h, w)) < 0.45,
                                   rng.random((h, w)) < 0.1])).to(dev)
    got = ccl.connected_components_strip_batch(b, 24)
    assert torch.equal(got, ccl.connected_components_plain(b, 24))


def test_extract_kernel_edge_cases(dev):
    """Four tied farthest points, +-0.0 side distances that tie, a root in
    two slots, an absent root, empty slots, a plane-wide bar and a ring on
    every edge: bit for bit the plain version."""
    labels, roots = extract_cases()
    lab = torch.from_numpy(labels).to(dev)
    r = torch.from_numpy(roots).to(dev)
    got = extract.extreme_quads(lab, r)
    assert torch.equal(got, extract.extreme_quads_plain(lab, r))
    assert torch.equal(got[0, 1, 1], got[0, 1, 0])  # B = A on the +-0 tie


def _cg_problem(dev):
    """The seed-4 synthetic map's row-split grouped equations (rows of 2
    slots) on ``dev`` in float64, and what the CG solve needs."""
    from ar_slam_tpu_torch.convert import arrays_from_numpy
    from ar_slam_tpu_torch.solve.lm import make_grouped_hooks
    from torch_cases import slot_bounds, synthetic_arrays

    a = synthetic_arrays(seed=4)
    s_tag, s_cap, n_rows, n_cap_rows = slot_bounds(a, 2)
    t = arrays_from_numpy(a, dev, torch.float64)
    lin, _, ctx = make_grouped_hooks(
        t["cap_idx"], t["tag_idx"], t["corners"], t["block_mask"], 0.0635,
        a.cap_poses.shape[0], a.tag_poses.shape[0], s_tag, s_cap,
        row_slots=2, n_rows=n_rows, n_cap_rows=n_cap_rows)
    eqs, _ = lin(t["camera"], t["cap_poses"], t["tag_poses"])
    cap_act = t["cap_mask"].clone()
    cap_act[0] = False
    return eqs, ctx, cap_act, t, (s_tag, n_rows)


@pytest.mark.parametrize("tol,iters", [(0.3, 25), (1e-10, 100)])
def test_cg_solve_no_sync_matches_cpu(dev, tol, iters):
    """The row-split grouping and schur_solve_grouped_cg read nothing back
    to the host (set_sync_debug_mode("error") raises on any synchronising
    call), and equal the CPU float64 results: the grouping exactly, the
    solve within 1e-8 relative."""
    from ar_slam_tpu_torch.solve import schur

    out = {}
    for d in ("cpu", dev):
        eqs, ctx, cap_act, t, (s_tag, n_rows) = _cg_problem(d)
        torch.cuda.synchronize()
        if d == dev:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rows = schur.group_blocks_by_tag_rows(
                t["tag_idx"], t["block_mask"], t["tag_poses"].shape[0], 2,
                n_rows, -(-s_tag // 2))
            sol = schur.schur_solve_grouped_cg(
                eqs, ctx[0], ctx[1], ctx[2], 1e-4, True, cap_act,
                t["tag_mask"], cg_tol=tol, cg_iters=iters, rows=ctx[3],
                cap_rows=ctx[4])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[str(d)] = rows, sol
    (g_c, m_c, r_c), sol_c = out["cpu"]
    (g_d, m_d, r_d), sol_d = out[str(dev)]
    assert torch.equal(g_d.cpu(), g_c) and torch.equal(m_d.cpu(), m_c)
    for a, b in zip(r_d, r_c):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(sol_d, sol_c):
        assert ((a.cpu() - b).abs().max() / b.abs().max()).item() <= 1e-8
