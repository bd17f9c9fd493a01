"""Inputs shared by the port's CPU and card tests of K2, K3 and K4 (numpy
only, so the card's test run, which has no jax, imports it too)."""

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
