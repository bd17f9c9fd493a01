"""Inputs shared by the port's CPU and card tests of K2, K3, K4, K6 and
the solver (numpy and the port only, so the card's test run, which has no jax,
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


def rank_rows(h=23, w=31, seed=11):
    """Rows of pooled label grids (h x w, row-major) for the ranking's edge
    cases, {name: (B, h * w) int32}, each ranked with grid width ``w``:

    - ``all_big``: background only;
    - ``one_run``: one label filling the row;
    - ``single_ends``: no background, the lowest and the highest label
      once each, so the sorted row starts and ends with a one-cell run;
    - ``ties``: twelve equal hollow 3x3 rings labelled in grid order, so
      their scores are equal and the cut must fall to the lower labels;
    - ``demoted``: a component over a quarter of the grid beside small
      ones, which ``max_area`` demotes;
    - ``shuffled``: 40 labels scattered over 70 % of the cells, so lower
      labels often first appear later in the grid than higher ones (the
      running maximum of the first positions is then not the run's own).
    """
    rng = np.random.default_rng(seed)
    p = h * w
    rows = {"all_big": np.full((1, p), BIG, np.int32),
            "one_run": np.full((1, p), 7, np.int32)}
    ends = rng.integers(10, 60, size=p).astype(np.int32)
    lo, hi = rng.choice(p, size=2, replace=False)
    ends[lo], ends[hi] = 3, 1000
    rows["single_ends"] = ends[None]
    ties = np.full((h, w), BIG, np.int32)
    labels = np.arange(12) * 7 + 1
    for n, lab in enumerate(labels):
        y, x = 1 + 5 * (n // 6), 1 + 5 * (n % 6)
        ties[y:y + 3, x:x + 3] = lab
        ties[y + 1, x + 1] = BIG
    rows["ties"] = ties.reshape(1, -1)
    demoted = np.full((h, w), BIG, np.int32)
    demoted[:h // 2 + 2, :] = 2
    demoted[h - 4:h - 1, 2:5] = 900
    demoted[h - 3, 10:20] = 400
    rows["demoted"] = demoted.reshape(1, -1)
    shuffled = rng.integers(0, 40, size=(2, p)).astype(np.int32)
    shuffled[rng.random((2, p)) < 0.3] = BIG
    rows["shuffled"] = shuffled
    return rows


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


def bfs_waves(a, order, single: bool = False):
    """The waves a BFS over captures ``order`` of arrays ``a`` queues (as
    ``solve.batch._WaveRunner.run_wave``): (seed_cap, seed_row, tag_rows,
    tags, anchor_rows); the first keeps its pose, each later one is
    seeded from its anchors (``single``: its first anchor only)."""
    known, waves = set(), []
    for k, cap in enumerate(order):
        rows = np.flatnonzero((a.cap_idx == cap) & a.block_mask)
        new = [int(r) for r in rows if a.tag_idx[r] not in known]
        anchors = [int(r) for r in rows if a.tag_idx[r] in known]
        known |= {int(a.tag_idx[r]) for r in new}
        seed_row = anchors[0] if k and anchors else -1
        if single and seed_row >= 0:
            anchors = [seed_row]
        waves.append((cap, seed_row, new, [int(a.tag_idx[r]) for r in new],
                      anchors if seed_row >= 0 else []))
    return waves


def localize_queries(seed=8, n_tags=12, n_caps=6, width=None):
    """(camera, tag poses, q_tag_idx, q_corners, q_mask, q_seed) float64 /
    int64 numpy: every capture of a synthetic map as a query against its
    true tag poses (perturbed by 1e-3), padded to the widest query, plus
    one query without blocks.  With ``width``, each query keeps at most
    its first ``width`` blocks, and the widest has that many."""
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    store, truth = make_synthetic_map(n_tags=n_tags, n_caps=n_caps,
                                      seed=seed)
    rng = np.random.default_rng(seed)
    tags = np.zeros((len(store.arucos), 6))
    for t in store.arucos:
        tags[t.index] = truth["tag_poses"][int(t.id.split("_")[-1])]
    tags += rng.normal(scale=1e-3, size=tags.shape)
    blocks = [c.blocks[:width] for c in store.captures]
    q = len(blocks) + 1
    k = max(len(b) for b in blocks)
    assert width is None or k == width, (k, width)
    q_tag = np.zeros((q, k), np.int64)
    q_crn = np.zeros((q, k, 4, 2))
    q_mask = np.zeros((q, k), bool)
    q_seed = np.zeros(q, np.int64)
    for qi, cap_blocks in enumerate(blocks):
        for ki, bh in enumerate(cap_blocks):
            q_tag[qi, ki] = store.blocks[bh].tag_idx
            q_crn[qi, ki] = store.blocks[bh].corners
            q_mask[qi, ki] = True
        q_seed[qi] = qi % len(cap_blocks)
    return store.camera.params.copy(), tags, q_tag, q_crn, q_mask, q_seed


def pad_queries(case, k=None, q=None, t=None):
    """``localize_queries``' arrays with the block axis padded to ``k``,
    the query axis to ``q`` (queries without blocks) and the tag rows to
    ``t``, with zeros, as ``localize_many`` pads them."""
    cam, tags, q_tag, q_crn, q_mask, q_seed = case
    dk = (k or q_tag.shape[1]) - q_tag.shape[1]
    dq = (q or q_tag.shape[0]) - q_tag.shape[0]

    def pad(a, *rest):
        return np.pad(a, ((0, dq), (0, dk), *rest))

    return (cam, np.pad(tags, ((0, (t or len(tags)) - len(tags)), (0, 0))),
            pad(q_tag), pad(q_crn, (0, 0), (0, 0)), pad(q_mask),
            np.pad(q_seed, (0, dq)))
