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


@pytest.mark.parametrize("tol,iters", [(0.3, 25), (1e-10, 100)])
def test_sharded_cg_solve_no_sync_matches_cpu(dev, tol, iters):
    """The tag-sharded CG solve over two shards of one card (its packed
    reductions included) reads nothing back to the host, and equals the
    same solve over two CPU shards in float64 within 1e-8 relative."""
    from ar_slam_tpu_torch.parallel import (TagShardedProblem, block_mesh,
                                            make_tag_sharded_hooks)
    from torch_cases import synthetic_arrays

    a = synthetic_arrays(seed=4)
    cap_act = a.cap_mask.copy()
    cap_act[0] = False
    out = {}
    for d in ("cpu", dev):
        mesh = block_mesh(devices=[d] * 2)
        prob = TagShardedProblem(mesh, a.cap_idx, a.tag_idx, a.corners,
                                 a.block_mask, a.tag_poses.shape[0],
                                 dtype=torch.float64)
        make_group, make_lin, _, make_solve = make_tag_sharded_hooks(
            mesh, prob.t_per, a.cap_poses.shape[0], 0.0635,
            obs_per_tag=prob.obs_per_tag, obs_per_cap=prob.obs_per_cap,
            linear_solver="cg", cg_tol=tol, cg_iters=iters,
            row_slots=prob.row_slots, shard_rows=prob.shard_rows,
            shard_cap_rows=prob.shard_cap_rows)
        grouped = make_group(prob.cap_idx, prob.tag_idx, prob.corners,
                             prob.block_mask(a.block_mask))
        tag_act = prob.put_tag_mask(a.tag_mask)
        cam, caps, cap_a = prob.put_rep(a.camera, a.cap_poses, cap_act)
        eqs, _ = make_lin(grouped, tag_act)(cam, caps,
                                            prob.put_tags(a.tag_poses))
        solve_fn = make_solve(True, cap_a, tag_act, grouped)
        lam = torch.full((), 1e-4, dtype=torch.float64, device=mesh.home)
        x0 = torch.zeros(3 + 6 * a.cap_poses.shape[0], dtype=torch.float64,
                         device=mesh.home)
        if d == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            before = mesh.reductions
            d_cam, d_cap, d_tag, delta_r = solve_fn(eqs, lam, x0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert mesh.reductions - before == iters + 2
        out[str(d)] = [d_cam, d_cap, torch.cat(list(d_tag)), delta_r]
    for got, ref in zip(out[str(dev)], out["cpu"]):
        assert ((got.cpu() - ref).abs().max() / ref.abs().max()).item() <= 1e-8


def test_sharded_detection_equals_unsharded(dev):
    """Five rendered frames over three shards of one card (the last one
    padding): every output equal to the unsharded batch's."""
    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.parallel.detect import (detect_batch_sharded,
                                                   image_mesh)
    from ar_slam_tpu_torch.utils.render import room_scene

    frames, _ = room_scene(n_frames=5, width=640, height=480, focal=565.0)
    got = detect_batch_sharded(frames, mesh=image_mesh(devices=[dev] * 3))
    ref = detect_batch(frames, device=dev)
    for name in ref:
        for key in ref[name]:
            assert torch.equal(got[name][key], ref[name][key])


def _lm_case(dev, n_tags, n_caps, solver, seed=3):
    """lm_solve's arguments on the card in float32: a synthetic map near
    its truth, and its slot bounds (row-split of 8 slots for CG)."""
    from ar_slam_tpu_torch.convert import arrays_from_numpy
    from ar_slam_tpu_torch.solve.lm import LMConfig
    from torch_cases import slot_bounds, synthetic_arrays

    a = synthetic_arrays(seed=seed, n_tags=n_tags, n_caps=n_caps,
                         perturb=0.005)
    s_tag, s_cap, n_rows, n_cap_rows = slot_bounds(a, 8)
    t = arrays_from_numpy(a, dev, torch.float32)
    args = (t["camera"], t["cap_poses"], t["tag_poses"], t["cap_idx"],
            t["tag_idx"], t["corners"], t["block_mask"], True,
            t["cap_mask"], t["tag_mask"])
    kw = dict(aruco_size=0.0635, obs_per_tag=s_tag, obs_per_cap=s_cap,
              row_slots=8, tag_rows=n_rows, cap_rows=n_cap_rows,
              config=LMConfig(max_iterations=12, linear_solver=solver))
    return args, kw


def _equal_solves(got, ref):
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    for k, r in ref[3].items():
        g = got[3][k]
        assert (torch.equal(g, r) if isinstance(r, torch.Tensor)
                else g == r), k


@pytest.mark.parametrize("solver,n_tags,n_caps",
                         [("dense", 500, 200), ("cg", 300, 120)])
def test_graphed_lm_equals_eager(dev, solver, n_tags, n_caps):
    """lm_solve's CUDA graphs give the eager loop's results bit for bit
    (synthetic-500 dense, a small CG map), with budgets 3 then the full
    12 through one capture, and the warmup's frozen camera."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import lm_solve

    graphs.CACHE.clear()
    args, kw = _lm_case(dev, n_tags, n_caps, solver)
    for budget, cam in ((3, True), (None, True), (None, False)):
        a = args[:7] + (cam,) + args[8:]
        ref = lm_solve(*a, iter_budget=budget, graphs=False, **kw)
        got = lm_solve(*a, iter_budget=budget, **kw)
        torch.cuda.synchronize()
        _equal_solves(got, ref)
    assert graphs.CACHE.captures == 1 and graphs.CACHE.replays > 0


def test_graph_cache_reuses_its_pool(dev):
    """Another signature replaces the LM program and captures into the
    same memory pool: one program held, and a smaller problem after a
    larger one adds less than half of what its own pool holds; each
    replays the eager results."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import lm_solve

    cases = [_lm_case(dev, n_tags, n_caps, "dense")
             for n_tags, n_caps in ((300, 120), (500, 200))]
    pools = []
    for order in ([0], [1, 0]):
        graphs.CACHE.clear()
        for args, kw in (cases[i] for i in order):
            ref = lm_solve(*args, iter_budget=3, graphs=False, **kw)
            got = lm_solve(*args, iter_budget=3, **kw)
            torch.cuda.synchronize()
            _equal_solves(got, ref)
            stats = graphs.CACHE.stats()
            assert stats["programs"] == 1
            pools.append(stats["pool_bytes"])
        assert graphs.CACHE.captures == len(order)
    small, large, both = pools
    assert 0 < small < large and both < large + small / 2
    graphs.CACHE.clear()


def test_graph_replays_do_not_sync(dev):
    """The stages read nothing back to the host: run eagerly on the card
    and replayed, both under set_sync_debug_mode("error")."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import grouped_bounds, lm_solve

    graphs.CACHE.clear()
    args, kw = _lm_case(dev, 200, 80, "cg")
    lm_solve(*args, iter_budget=2, **kw)  # captures
    (prog,) = graphs.CACHE._programs.values()
    n_tags = args[2].shape[0]
    eager = graphs.Program(graphs._lm_stages(
        kw["aruco_size"], kw["config"], args[1].shape[0], n_tags,
        grouped_bounds(n_tags, kw["config"], kw["obs_per_tag"],
                       kw["obs_per_cap"], kw["row_slots"], kw["tag_rows"],
                       kw["cap_rows"])), False)
    eager.load(**{k: v.clone() for k, v in prog.t.items() if k in (
        "in_camera", "in_cap_poses", "in_tag_poses", "cap_idx", "tag_idx",
        "corners", "block_mask", "cam_active", "cap_active", "tag_active")})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p in (eager, prog):
            for name in ("setup", "step", "accept", "step", "reject"):
                p.run(name)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for k in ("camera", "cap_poses", "tag_poses", "lam", "nu", "cost"):
        assert torch.equal(prog.t[k], eager.t[k]), k


def test_capture_beside_detect_thread(dev):
    """A capture succeeds while another thread runs detect_batch on the
    card (the pipelined serve loop, which captures and replays its own
    program), and replays the eager results."""
    import threading

    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import lm_solve

    frames = torch.from_numpy(_frames(4))
    detect_batch(frames, device=dev)  # builds the kernels
    stop, errors, runs = threading.Event(), [], [0]

    def detect_loop():
        try:
            while not stop.is_set():
                detect_batch(frames, device=dev)
                runs[0] += 1
        except Exception as e:  # reported by the main thread
            errors.append(e)

    graphs.CACHE.clear()
    args, kw = _lm_case(dev, 500, 200, "dense")
    ref = lm_solve(*args, graphs=False, **kw)
    th = threading.Thread(target=detect_loop)
    th.start()
    try:
        while runs[0] == 0 and not errors:
            stop.wait(0.01)
        got = lm_solve(*args, **kw)
        torch.cuda.synchronize()
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    assert graphs.CACHE.stats()["kinds"]["lm"]["captures"] == 1
    assert runs[0] > 0
    _equal_solves(got, ref)


def test_solve_and_localize_replay_graphs(dev):
    """solve and localize_many on the card replay graphs, bit for bit the
    eager loops (a synthetic map of 7 captures, 3 queries)."""
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve
    from ar_slam_tpu_torch.solve.localize import localize_many
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    src, _ = make_synthetic_map(n_tags=20, n_caps=10, seed=8)

    def add(store, caps):
        for cap in caps:
            store.add_detections(cap.uid, [
                (src.arucos[src.blocks[b].tag_idx].id, src.blocks[b].corners)
                for b in cap.blocks], src.camera.size)

    results = {}
    for g in (False, True):
        graphs.CACHE.clear()
        store = MapStore(initial_focal=3000.0)
        add(store, src.captures[:7])
        summary = solve(store, ArSlamConfig(), device=dev, graphs=g)
        add(store, src.captures[7:])
        loc = localize_many(store, 7, ArSlamConfig(), device=dev, graphs=g)
        results[g] = (summary, loc, [c.inv_pose.copy()
                                     for c in store.captures])
        assert (graphs.CACHE.replays > 0) == g
    (s0, l0, p0), (s1, l1, p1) = results[False], results[True]
    assert s0 == s1 and l0 == l1
    for a, b in zip(p0, p1):
        assert np.array_equal(a, b)


def _seed_case(dev):
    """seed_waves' arguments on the card in float32: three BFS waves of a
    synthetic map, each initializing tags, padded to W = 4."""
    from ar_slam_tpu_torch.convert import arrays_from_numpy
    from ar_slam_tpu_torch.graph.arrays import obs_bucket
    from ar_slam_tpu_torch.solve.batch import pack_waves
    from torch_cases import bfs_waves, synthetic_arrays

    a = synthetic_arrays(seed=7, n_tags=40, n_caps=10, perturb=0.05)
    slots = obs_bucket(int(np.bincount(a.cap_idx[a.block_mask]).max()))
    t = arrays_from_numpy(a, dev, torch.float32)
    tables = [torch.as_tensor(pack_waves(bfs_waves(a, order), slots),
                              device=dev) for order in ([3, 1, 5], [0, 2, 4])]
    return (t["camera"], t["cap_poses"], t["tag_poses"], t["tag_idx"],
            t["corners"]), tables


def test_graphed_seeds_equal_eager(dev):
    """The seed program's replays equal the eager stage bit for bit, for
    two flushes' tables through one capture."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import seed_waves

    graphs.CACHE.clear()
    args, tables = _seed_case(dev)
    kw = dict(aruco_size=0.0635, seed_mode="hybrid")
    for tab in tables:
        ref = seed_waves(*args, tab, **kw)
        got = graphs.seed_waves_graphed(*args, tab, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert not torch.equal(got[1], args[2])
    assert graphs.CACHE.captures == 1 and graphs.CACHE.replays == 2
    graphs.CACHE.clear()


def test_localize_call_replays_init(dev, monkeypatch):
    """A graphed localize call replays ``init`` and then ``iterate``,
    bit for bit localize_batch."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig
    from ar_slam_tpu_torch.solve.localize import localize_batch
    from torch_cases import localize_queries

    q = [torch.as_tensor(x, device=dev) for x in localize_queries()]
    q[0], q[1], q[3] = q[0].float(), q[1].float(), q[3].float()
    kw = dict(aruco_size=0.0635, config=LMConfig())
    ref = localize_batch(*q, **kw)
    replayed, replay = [], graphs.Program.run

    def run(self, name):
        replayed.append((name, self.graphed))
        replay(self, name)

    monkeypatch.setattr(graphs.Program, "run", run)
    graphs.CACHE.clear()
    for _ in range(2):
        replayed.clear()
        got = graphs.localize_graphed(*q, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert replayed[0] == ("init", True)
        assert {n for n, _ in replayed[1:]} == {"iterate"}
    assert graphs.CACHE.captures == 1
    graphs.CACHE.clear()


class CaptureSyncs:
    """Counts the calls of ``torch.cuda.synchronize`` and
    ``torch.cuda.empty_cache`` that the capturing thread makes while a
    program captures (``graphs.Program._capture``)."""

    NAMES = ("synchronize", "empty_cache")

    def __init__(self, monkeypatch):
        import threading

        from ar_slam_tpu_torch.solve import graphs

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.captures = 0
        capturing = set()
        for name in self.NAMES:
            real = getattr(torch.cuda, name)

            def counted(*a, _name=name, _real=real, **k):
                if threading.get_ident() in capturing:
                    self.counts[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(torch.cuda, name, counted)
        capture = graphs.Program._capture

        def watched(prog):
            capturing.add(threading.get_ident())
            try:
                capture(prog)
            finally:
                capturing.discard(threading.get_ident())
            self.captures += 1

        monkeypatch.setattr(graphs.Program, "_capture", watched)


@pytest.mark.parametrize("detecting", [False, True])
def test_captures_make_no_device_sync(dev, monkeypatch, detecting):
    """A solve's captures (seed, LM) and a localize's make no
    torch.cuda.synchronize and no empty_cache call, also while another
    thread runs detect_batch on the card."""
    import threading

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve
    from ar_slam_tpu_torch.solve.localize import localize_many
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    frames = torch.from_numpy(_frames(4))
    detect_batch(frames, device=dev)  # builds the kernels
    store, _ = make_synthetic_map(n_tags=20, n_caps=8, seed=9)
    syncs = CaptureSyncs(monkeypatch)
    stop, errors, runs = threading.Event(), [], [0]

    def detect_loop():
        try:
            while not stop.is_set():
                detect_batch(frames, device=dev)
                runs[0] += 1
        except Exception as e:  # reported by the main thread
            errors.append(e)

    th = threading.Thread(target=detect_loop)
    graphs.CACHE.clear()
    if detecting:
        th.start()
    try:
        while detecting and runs[0] == 0 and not errors:
            stop.wait(0.01)
        out = solve(store, ArSlamConfig(), device=dev)
        loc = localize_many(store, 6, ArSlamConfig(), device=dev)
        torch.cuda.synchronize()
    finally:
        stop.set()
        if detecting:
            th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    assert out["rmse"] < 1.0 and loc["localized"] > 0
    assert syncs.captures >= 3, syncs.captures  # seed, lm, localize
    assert syncs.counts == {"synchronize": 0, "empty_cache": 0}
    graphs.CACHE.clear()


def _mesh_case(n_tags, n_caps, seed=3):
    """lm_solve_dist's arguments in float32 (numpy): a synthetic map near
    its truth."""
    from torch_cases import synthetic_arrays

    a = synthetic_arrays(seed=seed, n_tags=n_tags, n_caps=n_caps,
                         perturb=0.005)
    f32 = {k: getattr(a, k).astype(np.float32)
           for k in ("camera", "cap_poses", "tag_poses", "corners")}
    return (f32["camera"], f32["cap_poses"], f32["tag_poses"], a.cap_idx,
            a.tag_idx, f32["corners"], a.block_mask, True, a.cap_mask,
            a.tag_mask)


@pytest.mark.parametrize("solver,n_tags,n_caps",
                         [("dense", 500, 200), ("cg", 300, 120)])
def test_graphed_mesh_lm_equals_eager(dev, solver, n_tags, n_caps):
    """The tag-sharded LM over two shards of the card: its CUDA graphs
    give the eager stages' results bit for bit and count the same
    reductions, with budgets 3 then 12 and the warmup's frozen camera
    through one capture; the eager stages are ``lm_core``'s loop."""
    from ar_slam_tpu_torch.parallel import block_mesh, dist_lm
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig

    graphs.CACHE.clear()
    args = _mesh_case(n_tags, n_caps)
    meshes = [block_mesh(devices=[dev] * 2) for _ in range(2)]
    for budget, cam in ((3, True), (12, True), (12, False)):
        a = args[:7] + (cam,) + args[8:]
        kw = dict(aruco_size=0.0635, config=LMConfig(
            max_iterations=budget, linear_solver=solver))
        ref = dist_lm.lm_solve_dist(meshes[0], *a, graphs=False, **kw)
        got = dist_lm.lm_solve_dist(meshes[1], *a, **kw)
        torch.cuda.synchronize()
        _equal_solves(got, ref)
        assert meshes[0].reductions == meshes[1].reductions
    assert graphs.CACHE.captures == 1 and graphs.CACHE.replays > 0
    mesh = block_mesh(devices=[dev] * 2)
    prob = dist_lm.TagShardedProblem(mesh, *args[3:7], args[2].shape[0],
                                     dtype=torch.float32)
    placed = (*prob.put_rep(args[0], args[1]), prob.put_tags(args[2]),
              prob.block_mask(args[6]), *prob.put_rep(np.asarray(True),
                                                      args[8]),
              prob.put_tag_mask(args[9]))
    got = dist_lm.lm_solve_sharded(prob, 0.0635, kw["config"], *placed,
                                   graphs=False)
    ref = dist_lm._lm_sharded(prob, 0.0635, kw["config"], *placed)
    torch.cuda.synchronize()
    _equal_solves([*got[:2], torch.cat(list(got[2])), got[3]],
                  [*ref[:2], torch.cat(list(ref[2])), ref[3]])
    graphs.CACHE.clear()


def test_graphed_mesh_stages_do_not_sync(dev):
    """The mesh's CG stages read nothing back to the host: run eagerly on
    the card and replayed, both under set_sync_debug_mode("error"), with
    the same results."""
    from ar_slam_tpu_torch.parallel import block_mesh, dist_lm
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig

    graphs.CACHE.clear()
    args = _mesh_case(200, 80)
    config = LMConfig(max_iterations=2, linear_solver="cg")
    mesh = block_mesh(devices=[dev] * 2)
    dist_lm.lm_solve_dist(mesh, *args, aruco_size=0.0635, config=config)
    (prog,) = graphs.CACHE._programs.values()
    prob = dist_lm.TagShardedProblem(mesh, *args[3:7], args[2].shape[0],
                                     dtype=torch.float32)
    eager = graphs.Program(dist_lm._lm_stages(prob, 0.0635, config,
                                              args[1].shape[0]), False)
    eager.load(**{k: graphs._clone(v) for k, v in prog.t.items() if k in (
        "in_camera", "in_cap_poses", "in_tag_poses", "cap_idx", "tag_idx",
        "corners", "block_mask", "cam_active", "cap_active", "tag_active")})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p in (eager, prog):
            for name in ("setup", "step", "accept", "step", "reject"):
                p.run(name)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for k in ("camera", "cap_poses", "lam", "nu", "cost"):
        assert torch.equal(prog.t[k], eager.t[k]), k
    assert all(torch.equal(g, e) for g, e in zip(prog.t["tag_poses"],
                                                 eager.t["tag_poses"]))
    graphs.CACHE.clear()


def test_graphed_mesh_solve_equals_eager(dev):
    """A room-16-sized map (24 tags, 16 captures) solved with its tags
    over two shards of the card: the graphed seeds and LM give the eager
    stages' map bit for bit, one capture of each serving every flush."""
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.parallel import block_mesh
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    out = {}
    for graphed in (False, True):
        graphs.CACHE.clear()
        store, _ = make_synthetic_map(n_tags=24, n_caps=16, seed=5,
                                      noise_px=0.3)
        summary = solve(store, ArSlamConfig(), graphs=graphed,
                        mesh=block_mesh(devices=[dev] * 2))
        out[graphed] = (summary, [c.inv_pose for c in store.captures],
                        [t.pose for t in store.arucos], store.camera.params)
        stats = graphs.CACHE.stats()
    assert out[True][0] == out[False][0] and out[True][0]["rmse"] < 1.0
    for g, e in zip(out[True][1:], out[False][1:]):
        assert np.array_equal(np.asarray(g), np.asarray(e))
    assert stats["captures"] == 2 and stats["programs"] == 2
    assert [c["program"] for c in stats["capture_split_ms"]] == [
        "mesh_seed", "mesh_lm"]
    graphs.CACHE.clear()


def _cards(n):
    """The first ``n`` cards, or a skip where the machine has fewer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("solver,n_tags,n_caps",
                         [("dense", 500, 200), ("cg", 300, 120)])
def test_spread_mesh_graphs_equal_eager(solver, n_tags, n_caps):
    """The tag-sharded LM over shards spread on two cards (and over
    [cuda:0, cuda:1, cuda:0, cuda:1]): one graph a stage spanning the
    cards gives the eager stages' results bit for bit, counts the same
    reductions, and replays setup and two stages an iteration."""
    from ar_slam_tpu_torch.parallel import block_mesh, dist_lm
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig

    c0, c1 = _cards(2)
    args = _mesh_case(n_tags, n_caps)
    for devices in ([c0, c1], [c0, c1, c0, c1]):
        graphs.CACHE.clear()
        meshes = [block_mesh(devices=devices) for _ in range(2)]
        for budget, cam in ((3, True), (12, True), (12, False)):
            a = args[:7] + (cam,) + args[8:]
            kw = dict(aruco_size=0.0635, config=LMConfig(
                max_iterations=budget, linear_solver=solver))
            ref = dist_lm.lm_solve_dist(meshes[0], *a, graphs=False, **kw)
            replays = graphs.CACHE.replays
            got = dist_lm.lm_solve_dist(meshes[1], *a, **kw)
            torch.cuda.synchronize(c0)
            torch.cuda.synchronize(c1)
            _equal_solves(got, ref)
            assert meshes[0].reductions == meshes[1].reductions
            assert graphs.CACHE.replays - replays == (
                1 + 2 * got[3]["iterations"])
        assert graphs.CACHE.captures == 1
    graphs.CACHE.clear()


def test_spread_mesh_replays_do_not_sync():
    """The spread mesh's CG stages, replayed, read nothing back to the
    host (set_sync_debug_mode("error")) and give the eager stages'
    state; each card holds a pool of the program's own."""
    from ar_slam_tpu_torch.parallel import block_mesh, dist_lm
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig

    cards = _cards(2)
    graphs.CACHE.clear()
    args = _mesh_case(200, 80)
    config = LMConfig(max_iterations=2, linear_solver="cg")
    mesh = block_mesh(devices=cards)
    dist_lm.lm_solve_dist(mesh, *args, aruco_size=0.0635, config=config)
    (prog,) = graphs.CACHE._programs.values()
    (held,) = graphs.CACHE.stats()["held"]
    assert sorted(held["pool_bytes_per_card"]) == [str(c) for c in cards]
    assert all(n > 0 for n in held["pool_bytes_per_card"].values())
    prob = dist_lm.TagShardedProblem(mesh, *args[3:7], args[2].shape[0],
                                     dtype=torch.float32)
    eager = graphs.Program(dist_lm._lm_stages(prob, 0.0635, config,
                                              args[1].shape[0]), False)
    eager.load(**{k: graphs._clone(v) for k, v in prog.t.items() if k in (
        "in_camera", "in_cap_poses", "in_tag_poses", "cap_idx", "tag_idx",
        "corners", "block_mask", "cam_active", "cap_active", "tag_active")})
    for c in cards:
        torch.cuda.synchronize(c)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p in (eager, prog):
            for name in ("setup", "step", "accept", "step", "reject"):
                p.run(name)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for c in cards:
        torch.cuda.synchronize(c)
    for k in ("camera", "cap_poses", "lam", "nu", "cost"):
        assert torch.equal(prog.t[k], eager.t[k]), k
    assert all(torch.equal(g, e) for g, e in zip(prog.t["tag_poses"],
                                                 eager.t["tag_poses"]))
    graphs.CACHE.clear()


def test_spread_mesh_solve_equals_eager():
    """A room-16-sized map solved with its tags over two cards: the
    graphed seeds and LM give the eager stages' map bit for bit, one
    capture of each."""
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.parallel import block_mesh
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    cards = _cards(2)
    out = {}
    for graphed in (False, True):
        graphs.CACHE.clear()
        store, _ = make_synthetic_map(n_tags=24, n_caps=16, seed=5,
                                      noise_px=0.3)
        summary = solve(store, ArSlamConfig(), graphs=graphed,
                        mesh=block_mesh(devices=cards))
        out[graphed] = (summary, [c.inv_pose for c in store.captures],
                        [t.pose for t in store.arucos], store.camera.params)
        stats = graphs.CACHE.stats()
    assert out[True][0] == out[False][0] and out[True][0]["rmse"] < 1.0
    for g, e in zip(out[True][1:], out[False][1:]):
        assert np.array_equal(np.asarray(g), np.asarray(e))
    assert stats["captures"] == 2 and stats["programs"] == 2
    graphs.CACHE.clear()


@pytest.mark.parametrize("custom", [False, True])
def test_graphed_flat_lm_equals_eager(dev, custom):
    """lm_solve without bounds (the flat hooks) and with an assemble_fn
    replays CUDA graphs with the eager loop's results bit for bit (its
    sums in a fixed order), budgets 3 then 12 through one capture, and
    host-stepped calls (lam0 / nu0) the same."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import lm_solve
    from ar_slam_tpu_torch.solve.schur import assemble

    graphs.CACHE.clear()
    args, kw = _lm_case(dev, 120, 40, "dense")
    kw = dict(aruco_size=kw["aruco_size"], config=kw["config"])
    if custom:
        kw.update(assemble_fn=assemble, obs_per_tag=16)
    for budget, extra in ((3, {}), (12, {}), (1, dict(lam0=3e-3, nu0=8.0))):
        ref = lm_solve(*args, iter_budget=budget, graphs=False, **extra,
                       **kw)
        got = lm_solve(*args, iter_budget=budget, **extra, **kw)
        torch.cuda.synchronize()
        _equal_solves(got, ref)
        assert got[3]["iterations"] >= 1
    stats = graphs.CACHE.stats()
    assert stats["captures"] == 1 and stats["replays"] > 0
    graphs.CACHE.clear()


def test_assemble_fn_reading_the_host_raises(dev):
    """An assemble_fn that reads a value to the host cannot be captured:
    the solve raises, naming it."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import lm_solve
    from ar_slam_tpu_torch.solve.schur import assemble

    def reads_host(*a):
        float(a[0].sum())
        return assemble(*a)

    graphs.CACHE.clear()
    args, kw = _lm_case(dev, 60, 20, "dense")
    kw = dict(aruco_size=0.0635, config=kw["config"], iter_budget=2)
    with pytest.raises(RuntimeError, match="reads_host"):
        lm_solve(*args, assemble_fn=reads_host, **kw)
    # the failed capture left its pool: the next program captures into it
    got = lm_solve(*args, assemble_fn=assemble, **kw)
    ref = lm_solve(*args, assemble_fn=assemble, graphs=False, **kw)
    torch.cuda.synchronize()
    _equal_solves(got, ref)
    assert graphs.CACHE.captures == 1
    graphs.CACHE.clear()


def test_progress_replays_graphs(dev, capsys):
    """Host-stepped progress on the card: each printed iteration is a
    load and replays of the LM program, its cost bit for bit the eager
    stepping's."""
    import dataclasses

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.solve import batch, graphs
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    config = ArSlamConfig()
    config = dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, minimizer_progress_to_stdout=True))
    costs = {}
    orig = batch.lm_solve
    for graphed in (False, True):
        graphs.CACHE.clear()
        costs[graphed] = []

        def rec(*a, **k):
            out = orig(*a, **k)
            costs[graphed].append(float(out[3]["cost"]))
            return out

        store, _ = make_synthetic_map(n_tags=16, n_caps=6, seed=3,
                                      noise_px=0.3)
        batch.lm_solve = rec
        try:
            batch.solve(store, config, dtype=torch.float64, device=dev,
                        graphs=graphed)
        finally:
            batch.lm_solve = orig
        stats = graphs.CACHE.stats()
    capsys.readouterr()
    assert costs[True] == costs[False] and len(costs[True]) >= 2
    assert stats["kinds"]["lm"]["replays"] >= len(costs[True])
    graphs.CACHE.clear()


@pytest.fixture(scope="module")
def scenes():
    """Rendered frames of chip_smoke's cells: 8 of room-16 (1020x768:
    K2) and 2 of phone_12mp (4032x3024, 50 mm tags: K3)."""
    from ar_slam_tpu_torch.utils.render import PHONE_12MP, room_scene

    return {"room": room_scene(n_frames=8)[0],
            "phone": room_scene(n_frames=2, aruco_size=0.05,
                                **PHONE_12MP)[0]}


def _detect_counts():
    from ar_slam_tpu_torch.detect.detect import COUNTED

    return [getattr(obj, attr) for obj, attr in COUNTED]


def _plane_rounds(cell):
    return (ccl.fused_plane_rounds() if cell == "room"
            else ccl.strip_plane_rounds())


def _equal_detections(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


@pytest.mark.parametrize("cell", ["room", "phone"])
def test_graphed_detect_equals_eager(dev, scenes, cell):
    """detect_batch replays one CUDA graph per batch shape, K1-K4 inside
    (K2 on room-16's planes, K3 on 12 MP ones): bit for bit the eager
    stage's outputs, the same launch counts and the same per-plane CCL
    rounds after each replay; the first call captures, later calls of
    the shape replay, another shape captures its own."""
    from ar_slam_tpu_torch import programs
    from ar_slam_tpu_torch.detect.detect import detect_batch

    frames = scenes[cell]
    programs.CACHE.clear()
    before = _detect_counts()
    ref = detect_batch(frames, device=dev, graphs=False)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_detect_counts(), before)]
    rounds = _plane_rounds(cell)
    assert all(launched[:2]) and launched[-1] == 1
    assert int(sum(ref[n]["valid"].sum() for n in ref)) > 0
    for call in range(3):
        before = _detect_counts()
        got = detect_batch(frames, device=dev)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_detect_counts(), before)] == launched
        assert _equal_detections(got, ref) and _plane_rounds(cell) == rounds
    kinds = programs.CACHE.stats()["kinds"]
    assert kinds == {"detect": {"captures": 1, "replays": 3}}
    half = detect_batch(frames[:1], device=dev)
    torch.cuda.synchronize()
    assert _equal_detections(half, detect_batch(frames[:1], device=dev,
                                                graphs=False))
    assert programs.CACHE.stats()["kinds"]["detect"] == {"captures": 2,
                                                         "replays": 4}
    assert programs.CACHE.stats()["programs"] == 2
    programs.CACHE.clear()


def test_detect_replay_does_not_sync(dev, scenes):
    """A graphed detect_batch call on frames on the card (the copy into
    the program's buffer, the replay, the outputs' copies) runs under
    set_sync_debug_mode("error"); only the outputs' copy to the host,
    after it, reads the card."""
    from ar_slam_tpu_torch import programs
    from ar_slam_tpu_torch.detect.detect import detect_batch

    frames = torch.from_numpy(scenes["room"]).to(dev)
    programs.CACHE.clear()
    ref = detect_batch(frames, device=dev, graphs=False)
    detect_batch(frames, device=dev)  # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = detect_batch(frames, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = {n: {k: v.cpu() for k, v in d.items()} for n, d in got.items()}
    assert _equal_detections(host, {n: {k: v.cpu() for k, v in d.items()}
                                    for n, d in ref.items()})
    programs.CACHE.clear()


def test_detect_capture_beside_lm_capture(dev, scenes, monkeypatch):
    """A worker thread captures and replays the detector while this
    thread captures and replays an LM (serve's detect thread beside its
    solve): neither capture disturbs the other's queued work, both
    replay their eager results bit for bit, one capture of each, and
    neither capture calls torch.cuda.synchronize or empty_cache."""
    import threading

    from ar_slam_tpu_torch import programs
    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.solve.lm import lm_solve

    frames = scenes["room"]
    ref_det = detect_batch(frames, device=dev, graphs=False)
    args, kw = _lm_case(dev, 500, 200, "dense")
    ref = lm_solve(*args, graphs=False, **kw)
    torch.cuda.synchronize()
    programs.CACHE.clear()
    syncs = CaptureSyncs(monkeypatch)
    go, errors, found = threading.Event(), [], []

    def detect_loop():
        try:
            go.wait(timeout=60)
            for _ in range(4):
                found.append(detect_batch(frames, device=dev))
        except Exception as e:  # reported by the main thread
            errors.append(e)

    th = threading.Thread(target=detect_loop)
    th.start()
    try:
        go.set()
        got = [lm_solve(*args, **kw) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        go.set()
        th.join(timeout=120)
    torch.cuda.synchronize()
    assert not th.is_alive() and not errors, errors
    kinds = programs.CACHE.stats()["kinds"]
    assert kinds["detect"] == {"captures": 1, "replays": 4}
    assert kinds["lm"]["captures"] == 1 and kinds["lm"]["replays"] > 0
    assert syncs.captures == 2
    assert syncs.counts == {"synchronize": 0, "empty_cache": 0}
    for g in got:
        _equal_solves(g, ref)
    assert len(found) == 4 and all(_equal_detections(f, ref_det)
                                   for f in found)
    programs.CACHE.clear()


def test_engine_padding_on_card(dev, scenes):
    """The engine detects 3 frames as a padded batch of 4 (a zero frame
    last, another program shape): the zero frame detects nothing, and
    the 3 frames give the unpadded batch's ids and validity exactly and
    its corners within 1e-4 px (the card's reductions may split
    differently at another batch size), also through the engine."""
    from ar_slam_tpu_torch import programs
    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine

    frames = scenes["room"][:3]
    engine = ArSlamEngine(device=dev)
    params = engine.detect_params()
    names = tuple(engine.config.detect.dictionaries)
    programs.CACHE.clear()
    padded = np.concatenate([frames, np.zeros_like(frames[:1])])
    got = detect_batch(padded, params=params, dict_names=names, device=dev)
    ref = detect_batch(frames, params=params, dict_names=names, device=dev)
    for name in names:
        assert not got[name]["valid"][3].any()
        valid = ref[name]["valid"]
        assert torch.equal(got[name]["valid"][:3], valid)
        assert torch.equal(got[name]["ids"][:3], ref[name]["ids"])
        assert valid.any()
        diff = (got[name]["corners"][:3] - ref[name]["corners"])[valid]
        assert diff.abs().max().item() <= 1e-4
    per_image = engine._run_detector(frames, names)
    center = np.array([frames.shape[2] / 2.0, frames.shape[1] / 2.0])
    for i, by_dict in enumerate(per_image):
        for name in names:
            v = ref[name]["valid"][i].cpu().numpy()
            want = dict(zip(ref[name]["ids"][i].cpu().numpy()[v],
                            ref[name]["corners"][i].cpu().numpy()[v]))
            dets = by_dict[f"aruco_{name}"]
            assert sorted(int(t.rsplit("_", 1)[1]) for t, _ in dets) \
                == sorted(want)
            for tag, c in dets:
                assert np.abs(c + center - want[int(tag.rsplit("_", 1)[1])]
                              ).max() <= 1e-4
    assert programs.CACHE.stats()["kinds"]["detect"]["captures"] == 2
    programs.CACHE.clear()
