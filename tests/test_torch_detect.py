"""Port parity: the detection kernels' plain versions against the Pallas
kernels (interpret mode) and their XLA contracts, the detect_batch
helpers, and detect_batch itself against the JAX detector on rendered
frames (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.detect import tpu_detect as jdet
from ar_slam_tpu.detect.gen import render_marker
from ar_slam_tpu.detect.pallas_box import box_mean_batch as j_box_mean
from ar_slam_tpu.detect.pallas_box import box_sum_batch as j_box_sum
from ar_slam_tpu.detect.pallas_ccl import connected_components_fused_batch
from ar_slam_tpu.detect.pallas_extract import extreme_quads_pallas
from ar_slam_tpu_torch.detect import box, ccl, extract
from ar_slam_tpu_torch.detect import detect as tdet
from tests.test_detect import place_marker
from torch_cases import cap_planes, extract_cases, rank_rows

torch.set_num_threads(1)


@pytest.mark.parametrize("win", [3, 11, 13, 23])
def test_box_plain_matches_pallas_and_integral_image(win):
    """Windows 11 and 23: the contract of tests/test_pallas.py:98-113
    (rtol 1e-5, atol 1e-2 against the integral image), and the Pallas
    kernel itself.  Windows 3 and 13: the reference's prefix sums reach
    ~1.3e6 on these frames (float32 ulp 0.125), so there both reference
    forms are held at atol 0.25 (two prefix ulps).  Every window: the plain
    direct sum within 1e-6 relative of a float64 sum."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, size=(2, 37, 141)).astype(np.float32)
    got = box.box_sum_batch(torch.from_numpy(imgs), win).numpy()
    atol = 1e-2 if win in (11, 23) else 0.25
    ref = np.stack([np.asarray(jdet.box_mean(jnp.asarray(im), win))
                    * win * win for im in imgs])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    pallas = np.asarray(j_box_sum(jnp.asarray(imgs), win, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)
    f64 = box.box_sum_plain(torch.from_numpy(imgs.astype(np.float64)), win)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(got, f64.numpy(), rtol=1e-6)


def _ccl_batch():
    """tests/test_pallas.py:42-66: blobs, a ring, a serpentine border,
    noise and an all-background frame at a non-aligned size."""
    rng = np.random.default_rng(0)
    h, w = 61, 150
    img = np.zeros((h, w), bool)
    img[5:20, 5:25] = True
    img[25:50, 30:60] = True
    img[30:45, 35:55] = False
    for i, r in enumerate(range(4, 52, 8)):
        img[r, 70:140] = True
        if r + 8 < 52:
            img[r:r + 9, 70 if i % 2 else 139] = True
    img |= rng.random((h, w)) < 0.08
    return np.stack([img, rng.random((h, w)) < 0.3, np.zeros((h, w), bool)])


def test_ccl_plain_matches_fused_pallas():
    batch = _ccl_batch()
    ref = connected_components_fused_batch(jnp.asarray(batch), iters=64,
                                           interpret=True)
    got = ccl.connected_components_batch(torch.from_numpy(batch))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("iters", [1, 2, 3, 5, 24])
def test_ccl_fused_plain_matches_pallas_under_cap(iters):
    """K2's plain version (the CPU branch of its wrapper) equals the fused
    Pallas kernel label for label at its cap: several 64-row strips and
    128-wide column groups, a serpentine the cap cuts short, 45 % noise
    and the serpentine with 5 % noise.  At 24 rounds neither the uncapped
    fixpoint nor Jacobi rounds give the noise plane's labels."""
    batch = cap_planes()
    ref = np.asarray(connected_components_fused_batch(
        jnp.asarray(batch), iters=iters, interpret=True))
    t = torch.from_numpy(batch)
    got = ccl.connected_components_batch(t, iters).numpy()
    np.testing.assert_array_equal(got, ref)
    snake = got[0][batch[0]]
    assert len(np.unique(snake)) > 1  # the cap binds
    if iters == 24:
        for other in (ccl.connected_components_plain(t[1:2]),
                      ccl.connected_components_plain(t[1:2], iters)):
            assert not np.array_equal(other.numpy()[0], ref[1])


def _count_pool_jnp(binary, d):
    """tpu_detect.py:749-760, the count pool of the binary planes."""
    m, h, w = binary.shape
    hd, wd = -(-h // d), -(-w // d)
    bpad = binary
    if (hd * d, wd * d) != (h, w):
        bpad = jnp.pad(binary, ((0, 0), (0, hd * d - h), (0, wd * d - w)))
    counts = bpad.reshape(m, hd, d, wd, d).astype(jnp.int32).sum(axis=(2, 4))
    return counts >= (d * d + 1) // 2


@pytest.mark.parametrize("decimate", [1, 2, 3])
def test_threshold_plain_matches_pallas(decimate):
    """K1's threshold use on uint8 frames at windows 3/13/23: exactly the
    reference's ``images < box_mean_batch(images, win) - c`` (Pallas,
    interpret mode; its prefix sums are exact at this size), stacked
    window-major and count-pooled, at sizes that leave partial d x d
    blocks."""
    rng = np.random.default_rng(8)
    base = rng.uniform(40, 220, size=(2, 5, 9))
    frames = np.kron(base, np.ones((8, 16)))[:, :37, :141]
    frames = np.clip(frames + rng.normal(scale=9.0, size=frames.shape), 0,
                     255).astype(np.uint8)
    windows, c = (3, 13, 23), 7.0
    imgs = jnp.asarray(frames).astype(jnp.float32)
    bins = jnp.concatenate([imgs < j_box_mean(imgs, win, interpret=True) - c
                            for win in windows])
    ref = np.asarray(_count_pool_jnp(bins, decimate) if decimate > 1
                     else bins)
    got = box.threshold_batch(torch.from_numpy(frames), windows, c, decimate)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.05 < ref.mean() < 0.6


@pytest.mark.parametrize("thresh_c", [7.0, 7.3])
def test_threshold_table_is_the_float_compare(thresh_c):
    """The card's compare ``sum >= table[p]`` equals the plain version's
    float32 ``p < sum / win^2 - thresh_c`` for every pixel value and every
    window sum, at the default constant and at one float32 cannot hold."""
    windows = (3, 13, 23)
    table = box.threshold_table(windows, thresh_c)
    p = torch.arange(256, dtype=torch.float32)[:, None]
    for i, win in enumerate(windows):
        sums = torch.arange(255 * win * win + 1)
        mean_c = (sums.to(torch.float32) / torch.tensor(float(win * win))
                  - thresh_c)
        from_table = sums[None] >= torch.from_numpy(table[i])[:, None]
        assert torch.equal(p < mean_c[None], from_table)


def test_detect_batch_uploads_uint8(monkeypatch):
    """The frames reach the threshold as uint8, on the detector's device,
    unconverted (a quarter of the bytes of float32 to upload)."""
    seen = []
    threshold = box.threshold_batch

    def spy(frames, *args):
        seen.append((frames.dtype, frames.device.type, tuple(frames.shape)))
        return threshold(frames, *args)

    monkeypatch.setattr(box, "threshold_batch", spy)
    frames, _ = _frames(n=1)
    tdet.detect_batch(frames, params=tdet.DetectParams(win_sizes=(3, 23)),
                      device="cpu")
    assert seen == [(torch.uint8, "cpu", frames.shape)]


def _extract_frame():
    img = np.zeros((64, 160), bool)
    img[4:20, 8:40] = True
    img[8:16, 12:36] = False
    img[30:60, 60:120] = True
    img[36:54, 66:114] = False
    img[5:9, 130:150] = True
    return img


def test_extract_plain_matches_pallas():
    """tests/test_pallas.py:69-95 frame: exact, argmax tie-breaks included;
    empty slots give (0, 0)."""
    img = _extract_frame()
    labels = np.asarray(jdet.connected_components(jnp.asarray(img), 6))
    k = 8
    roots, areas = jax.jit(lambda lab: jdet._top_k_components(
        lab.reshape(-1), k, img.shape[1]))(jnp.asarray(labels))
    ref = np.asarray(extreme_quads_pallas(jnp.asarray(labels)[None],
                                          jnp.asarray(roots)[None], k=k,
                                          strip=16, interpret=True)[0])
    got = extract.extreme_quads(torch.from_numpy(labels)[None],
                                torch.from_numpy(np.asarray(roots))[None])[0]
    valid = np.asarray(areas) > 0
    np.testing.assert_array_equal(got.numpy()[valid], ref[valid])
    assert (got.numpy()[~valid] == 0).all()


def test_extract_plain_edge_cases_match_pallas():
    """K4's edge cases (tests/torch_cases.py): four tied farthest points,
    side distances of +0.0 and -0.0 that tie, a plane-wide bar, a ring on
    every edge, a root in two slots and one absent: the plain version equals
    the Pallas kernel on every slot with a root; empty slots give (0, 0)."""
    labels, roots = extract_cases()
    ref = np.asarray(extreme_quads_pallas(jnp.asarray(labels),
                                          jnp.asarray(roots),
                                          k=roots.shape[1], strip=8,
                                          interpret=True))
    got = extract.extreme_quads(torch.from_numpy(labels),
                                torch.from_numpy(roots)).numpy()
    full = roots != 2**30
    np.testing.assert_array_equal(got[full], ref[full])
    assert (got[~full] == 0).all()
    assert (got[0, 5] == 0).all() and (got[1, 5] == 0).all()  # absent root
    np.testing.assert_array_equal(got[0, 4], got[0, 1])  # the same root twice
    np.testing.assert_array_equal(got[0, 1, 1], got[0, 1, 0])  # B = A: +-0 tie


@pytest.mark.parametrize("subsample", [1, 2])
def test_top_k_matches(subsample):
    batch = _ccl_batch()
    labels = np.asarray(jax.vmap(lambda b: jdet.connected_components(b, 64))(
        jnp.asarray(batch)))
    roots, areas = tdet.top_k_subsampled(torch.from_numpy(labels), 16,
                                         subsample, 0.25)
    for i in range(len(labels)):
        r_ref, a_ref = jax.jit(lambda lab: jdet._top_k_subsampled(
            lab, 16, subsample, 0.25))(jnp.asarray(labels[i]))
        np.testing.assert_array_equal(roots[i].numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(areas[i].numpy(), np.asarray(a_ref))


@pytest.mark.parametrize("max_area_frac", [None, 0.25])
@pytest.mark.parametrize("case", list(rank_rows()))
def test_top_k_edge_rows_match(case, max_area_frac):
    """top_k_components (the plain run scores K6 is held to, then the
    stable top-k sort) against _top_k_components on the ranking's edge
    rows (tests/torch_cases.py): background only, one run, one-cell runs
    at both ends, equal scores (the lower label first), a demoted
    oversized run, lower labels that first appear later: roots and areas
    exactly, k = 5 so that the cut falls inside the ties."""
    rows = rank_rows()[case]
    w = 31
    max_area = (max_area_frac * rows.shape[1] if max_area_frac is not None
                else None)
    roots, areas = tdet.top_k_components(torch.from_numpy(rows), 5, w,
                                         max_area)
    for i, row in enumerate(rows):
        r_ref, a_ref = jax.jit(lambda lab: jdet._top_k_components(
            lab, 5, w, max_area))(jnp.asarray(row))
        np.testing.assert_array_equal(roots[i].numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(areas[i].numpy(), np.asarray(a_ref))
    if case == "ties":  # the five lowest of the twelve tied ring labels
        tied = np.unique(rows[rows != 2**30])
        np.testing.assert_array_equal(roots[0].numpy(), tied[:5])
    if case == "demoted" and max_area is not None:
        # last, below the two small ones
        assert roots[0, :3].tolist() == [400, 900, 2]


def test_small_helpers_match():
    rng = np.random.default_rng(4)
    s = rng.uniform(0, 255, size=(6, 324)).astype(np.float32)
    s[0, :160] = 20.0
    np.testing.assert_allclose(tdet.otsu_batch(torch.from_numpy(s)).numpy(),
                               np.asarray(jax.jit(jdet.otsu_batch)(
                                   jnp.asarray(s))), rtol=1e-5)
    for n in (6, 7):
        np.testing.assert_allclose(
            tdet.grid_points(n, 3, 0.13, "cpu").numpy(),
            np.asarray(jdet._grid_points(n, 3, 0.13)), rtol=1e-6)
    g = rng.uniform(0, 255, size=(2, 9, 11)).astype(np.float32)
    gy, gx = jax.jit(lambda a: jnp.gradient(a, axis=(1, 2)))(jnp.asarray(g))
    np.testing.assert_array_equal(tdet._gradient(torch.from_numpy(g), 1),
                                  np.asarray(gy))
    np.testing.assert_array_equal(tdet._gradient(torch.from_numpy(g), 2),
                                  np.asarray(gx))
    x = rng.normal(size=(5, 36)).astype(np.float32)
    np.testing.assert_allclose(tdet._median(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(lambda a: jnp.median(
                                   a, axis=1))(jnp.asarray(x))), rtol=1e-6)
    r = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)  # half to even
    np.testing.assert_array_equal(torch.round(torch.from_numpy(r)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(r))))


def test_postprocess_quads_matches():
    rng = np.random.default_rng(5)
    quads = rng.uniform(0, 200, size=(3, 8, 4, 2)).astype(np.float32)
    areas = rng.uniform(0, 300, size=(3, 8)).astype(np.float32)
    areas[:, 0] = 0.0
    params = tdet.DetectParams()
    q, a, v = tdet.postprocess_quads(torch.from_numpy(quads),
                                     torch.from_numpy(areas), 480, 640,
                                     params, scale=2)
    ref = jax.jit(jax.vmap(lambda qq, aa: jdet._postprocess_quads(
        qq, aa, 480, 640, jdet.DetectParams(), scale=2)))
    q_ref, _, v_ref = ref(jnp.asarray(quads), jnp.asarray(areas))
    for i in range(3):
        qr, vr = q_ref[i], v_ref[i]
        np.testing.assert_allclose(q[i].numpy(), np.asarray(qr), atol=1e-3)
        np.testing.assert_array_equal(v[i].numpy(), np.asarray(vr))


def _frames(n=3, seed=7):
    rng = np.random.default_rng(seed)
    frames, truth = [], []
    layout = [("4X4_50", 150, 130, 110), ("5X5_100", 460, 150, 130),
              ("4X4_50", 200, 360, 80), ("5X5_100", 480, 370, 60)]
    for _ in range(n):
        canvas = np.full((480, 640), 200, np.uint8)
        ids = []
        for name, cx, cy, s in layout:
            mid = int(rng.integers(0, 50))
            quad = np.array([[cx - s / 2, cy - s / 2], [cx + s / 2, cy - s / 2],
                             [cx + s / 2, cy + s / 2], [cx - s / 2, cy + s / 2]]
                            ) + rng.uniform(-0.12 * s, 0.12 * s, size=(4, 2))
            place_marker(canvas, render_marker(name, mid, 96), quad)
            ids.append((name, mid))
        noisy = canvas + rng.normal(scale=3.0, size=canvas.shape)
        frames.append(np.clip(noisy, 0, 255).astype(np.uint8))
        truth.append(ids)
    return np.stack(frames), truth


def test_detect_batch_matches_jax():
    """Three rendered 480x640 frames, both dictionaries, the default
    three-window sweep: ids equal the JAX detector's exactly; corners
    within 0.25 px.  The bound: the JAX CPU path thresholds with float32
    integral images and box-filters the refine field maps the same way,
    while the port sums windows directly, so field sums differ by ~1e-5
    relative and the refined corners by up to ~0.1 px (measured); 0.25 px
    leaves room without admitting a wrong corner (cells are >= 8 px)."""
    frames, truth = _frames()
    kw = dict(win=3, win_sizes=(3, 13, 23), max_candidates=64)
    names = ("4X4_50", "5X5_100")
    ref = jdet.detect_batch(jnp.asarray(frames), params=jdet.DetectParams(
        **kw), dict_names=names)
    got = tdet.detect_batch(frames, params=tdet.DetectParams(**kw),
                            dict_names=names, device="cpu")
    for name in names:
        for i in range(len(frames)):
            rv = np.asarray(ref[name]["valid"][i])
            gv = got[name]["valid"][i].numpy()
            r_ids = np.asarray(ref[name]["ids"][i])[rv]
            g_ids = got[name]["ids"][i].numpy()[gv]
            assert sorted(g_ids) == sorted(r_ids)
            assert sorted(g_ids) == sorted(m for d, m in truth[i] if d == name)
            r_c = dict(zip(r_ids, np.asarray(ref[name]["corners"][i])[rv]))
            g_c = dict(zip(g_ids, got[name]["corners"][i].numpy()[gv]))
            for mid in r_c:
                assert np.abs(g_c[mid] - r_c[mid]).max() <= 0.25


def test_detect_batch_refuses_planes_beyond_k2(monkeypatch):
    """Above the fused-CCL plane size the port no longer refuses: like the
    reference it switches to the strip-scan CCL (K3) with the round cap
    ``ccl_iters``.  A blank 2400x2400 frame (padded decimated plane
    1280x1280 > 1M px) takes that branch and detects nothing."""
    calls = []
    strip = ccl.connected_components_strip_batch

    def spy(binary, iters):
        calls.append((tuple(binary.shape), iters))
        return strip(binary, iters)

    monkeypatch.setattr(ccl, "connected_components_strip_batch", spy)
    out = tdet.detect_batch(np.zeros((1, 2400, 2400), np.uint8),
                            device="cpu")
    assert calls == [((1, 1200, 1200), 24)]
    for name in out:
        assert not out[name]["valid"].any()
