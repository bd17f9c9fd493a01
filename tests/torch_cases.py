"""Inputs shared by the port's CPU and card tests of K2, K3, K4 and the
solver (numpy and the port only, so the card's test run, which has no jax,
imports it too)."""

import numpy as np

BIG = 2**30


def serpentine(h, w, pitch=6):
    """Horizontal bars joined at alternate ends: each CCL round carries the
    minimum label about one bar further, so it needs ~h / pitch rounds."""
    img = np.zeros((h, w), bool)
    ys = list(range(2, h - 2, pitch))
    for i, y in enumerate(ys):
        img[y, 2:w - 2] = True
        if i + 1 < len(ys):
            x = w - 3 if i % 2 == 0 else 2
            img[y:ys[i + 1] + 1, x] = True
    return img


def cap_planes(h=150, w=200, seed=1):
    """Three planes on which K2's round cap binds differently: a serpentine
    (the cap cuts it short), 45 % noise (where Gauss-Seidel, Jacobi and the
    fixpoint all differ at 24 rounds) and the serpentine with 5 % noise."""
    rng = np.random.default_rng(seed)
    snake = serpentine(h, w)
    return np.stack([snake, rng.random((h, w)) < 0.45,
                     snake | (rng.random((h, w)) < 0.05)])


def mixed_batch(h=120, w=45, seed=7):
    """Three planes that stop at different rounds: blobs that converge in
    two or three rounds, a serpentine of 29 bars that no cap up to 24 rounds
    resolves, and dense noise."""
    quick = np.zeros((h, w), bool)
    quick[3:9, 4:12] = True
    quick[20:23, 30:40] = True
    quick[40:60, 10] = True
    quick[70, 5:40] = True
    rng = np.random.default_rng(seed)
    return np.stack([quick, serpentine(h, w, pitch=4),
                     rng.random((h, w)) < 0.45])


def _labelled(mask, into):
    """Paint one component, labelled by its lowest linear index."""
    into[mask] = np.flatnonzero(mask)[0]
    return int(into[mask][0])


def extract_cases(h=40, w=52):
    """(2, h, w) int32 labels and (2, 8) int32 roots for K4's edge cases:
    a symmetric diamond (four tied farthest points), an anti-diagonal line
    (side distances of +0.0 and -0.0 that must tie), a bar as wide as the
    plane, a ring touching every edge, a root in two slots, a root absent
    from its plane, and empty slots."""
    labels = np.full((2, h, w), BIG, np.int32)
    y, x = np.mgrid[:h, :w]
    diamond = _labelled(np.abs(x - 12) + np.abs(y - 10) <= 6, labels[0])
    anti = np.zeros((h, w), bool)
    for t in range(8):
        anti[3 + t, 40 - t] = True
    antidiag = _labelled(anti, labels[0])
    bar = _labelled((y >= 30) & (y <= 31), labels[0])
    ring = _labelled((y == 0) | (y == h - 1) | (x == 0) | (x == w - 1),
                     labels[1])
    blob = _labelled((np.abs(x - 20) <= 5) & (np.abs(y - 15) <= 3),
                     labels[1])
    absent = 5  # background in both planes
    roots = np.array([[diamond, antidiag, bar, BIG, antidiag, absent, BIG,
                       diamond],
                      [ring, blob, BIG, BIG, ring, absent, blob, BIG]],
                     np.int32)
    return labels, roots


def synthetic_arrays(seed=3, n_tags=20, n_caps=10, perturb=0.01):
    """The padded float64 block arrays of a synthetic map (0.3 px corner
    noise) with every pose at its truth plus N(0, perturb)."""
    from ar_slam_tpu_torch.graph.arrays import export_arrays
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

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


def slot_bounds(arrs, row_slots=2):
    """(obs_per_tag, obs_per_cap) bucketed to multiples of 8, and the
    row-split budgets (tag_rows, cap_rows) for ``row_slots``, each sum_i
    ceil(obs_i / row_slots) rounded up to a multiple of 8."""
    def up8(n):
        return int(-(-n // 8) * 8)

    counts = [np.bincount(idx[arrs.block_mask])
              for idx in (arrs.tag_idx, arrs.cap_idx)]
    obs = [up8(c.max()) for c in counts]
    rows = [up8((-(-c // row_slots)).sum()) for c in counts]
    return obs[0], obs[1], rows[0], rows[1]
