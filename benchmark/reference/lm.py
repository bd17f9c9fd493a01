"""Plain Levenberg-Marquardt solves of the reprojection problem, in
PyTorch, for the benchmark's comparisons.

``bundle_adjust`` moves the focal, every capture and every tag: the
Marquardt-damped normal equations (J'J + lam diag(J'J)) d = -J'r, the tags
eliminated (Schur complement) and the focal-and-captures system solved
densely by Cholesky, a step kept only where the cost falls.
``localize`` moves each query's pose alone against fixed tags and focal,
every query its own 6 x 6 system.  Both stop where a kept step lowers the
cost by less than ``rtol`` of it, or the damping runs away.

Imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference.geometry import dtype_of, mm, project


def _linearize(focal, caps, tags, cap_idx, tag_idx, obs, size, precision):
    uv, _, j_f, j_c, j_t = project(focal, caps[cap_idx], tags[tag_idx], size,
                                   precision, jacobians=True)
    r = (uv - obs).reshape(obs.shape[0], 8)
    return r, j_f, j_c, j_t


def _cost(focal, caps, tags, cap_idx, tag_idx, obs, size, precision):
    uv = project(focal, caps[cap_idx], tags[tag_idx], size, precision)
    r = uv - obs
    return 0.5 * (r * r).sum()


def _jtj(a, b, precision):
    """(B, 8, m), (B, 8, n) -> (B, m, n) a'b."""
    return mm(a.transpose(1, 2), b, precision)


def _damp(h, lam):
    """h + lam * diag(h) on the last two axes."""
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    return h + torch.diag_embed(lam * d.clamp(min=1e-12))


def _by_tag(tag_idx, n_tags):
    """Blocks grouped by tag: (T, S) block indices, -1 padding."""
    order = torch.argsort(tag_idx, stable=True)
    counts = torch.bincount(tag_idx, minlength=n_tags)
    s = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(tag_idx.shape[0], device=tag_idx.device) - start[
        tag_idx[order]]
    table = torch.full((n_tags, s), -1, dtype=torch.int64,
                       device=tag_idx.device)
    table[tag_idx[order], slot] = order
    return table


def bundle_adjust(focal, cap_poses, tag_poses, cap_idx, tag_idx, observed,
                  aruco_size: float, precision: str = "f64",
                  max_iterations: int = 100, rtol: float = 1e-12,
                  tag_chunk: int = 512):
    """LM over focal, captures and tags from the given start.  Returns
    (focal, cap_poses, tag_poses, iterations) in the working dtype."""
    dt = dtype_of(precision)
    dev = cap_poses.device
    f = torch.as_tensor(focal, dtype=dt, device=dev).reshape(())
    caps, tags = cap_poses.to(dt).clone(), tag_poses.to(dt).clone()
    obs = observed.to(dt)
    cap_idx, tag_idx = cap_idx.to(torch.int64), tag_idx.to(torch.int64)
    n_c, n_t = caps.shape[0], tags.shape[0]
    n = 1 + 6 * n_c
    table = _by_tag(tag_idx, n_t)
    # each block's 7 rows of the focal-and-captures system
    rows = torch.cat([torch.zeros_like(cap_idx)[:, None],
                      1 + 6 * cap_idx[:, None]
                      + torch.arange(6, device=dev)], 1)
    args = (cap_idx, tag_idx, obs, aruco_size, precision)
    cost = _cost(f, caps, tags, *args)
    lam, it = 1e-4, 0
    while it < max_iterations:
        it += 1
        r, j_f, j_c, j_t = _linearize(f, caps, tags, *args)
        j_a = torch.cat([j_f, j_c], 2)  # (B, 8, 7)
        # the focal-and-captures block, the tags' blocks, the couplings
        u = torch.zeros((n, n), dtype=dt, device=dev)
        u_b = _jtj(j_a, j_a, precision)
        u.view(-1).index_add_(0, (rows[:, :, None] * n + rows[:, None, :])
                              .reshape(-1), u_b.reshape(-1))
        g_a = torch.zeros(n, dtype=dt, device=dev).index_add_(
            0, rows.reshape(-1), mm(j_a.transpose(1, 2), r[..., None],
                                    precision).reshape(-1))
        v = torch.zeros((n_t, 6, 6), dtype=dt, device=dev).index_add_(
            0, tag_idx, _jtj(j_t, j_t, precision))
        g_t = torch.zeros((n_t, 6), dtype=dt, device=dev).index_add_(
            0, tag_idx, mm(j_t.transpose(1, 2), r[..., None],
                           precision)[..., 0])
        w = _jtj(j_a, j_t, precision)  # (B, 7, 6)
        while True:
            s = _damp(u, lam)
            v_inv = torch.linalg.inv(_damp(v, lam))
            rhs = -g_a
            y = mm(w, v_inv[tag_idx], precision)  # (B, 7, 6)
            rhs = rhs.index_add(0, rows.reshape(-1), mm(
                y, g_t[tag_idx][..., None], precision).reshape(-1))
            for t0 in range(0, n_t, tag_chunk):
                blk = table[t0:t0 + tag_chunk]  # (Tc, S)
                ok = blk >= 0
                b = blk.clamp(min=0)
                yb = y[b] * ok[..., None, None]
                wb = w[b] * ok[..., None, None]
                prod = mm(yb[:, :, None], wb[:, None].transpose(-1, -2),
                          precision)  # (Tc, S, S, 7, 7)
                rb = rows[b]
                idx = rb[:, :, None, :, None] * n + rb[:, None, :, None, :]
                s.view(-1).index_add_(0, idx.reshape(-1), -prod.reshape(-1))
            chol, info = torch.linalg.cholesky_ex(s)
            if int(info) == 0:
                d_a = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
                d_t = mm(v_inv, (-g_t - torch.zeros_like(g_t).index_add(
                    0, tag_idx, mm(w.transpose(1, 2), d_a[rows][..., None],
                                   precision)[..., 0]))[..., None],
                         precision)[..., 0]
                f_new = f + d_a[0]
                caps_new = caps + d_a[1:].reshape(n_c, 6)
                tags_new = tags + d_t
                new = _cost(f_new, caps_new, tags_new, *args)
                if bool(torch.isfinite(new)) and bool(new < cost):
                    break
            lam *= 10.0
            if lam > 1e16:
                return f, caps, tags, it
        decrease = float(cost - new)
        f, caps, tags, cost = f_new, caps_new, tags_new, new
        lam = max(lam / 10.0, 1e-12)
        if decrease <= rtol * float(cost):
            break
    return f, caps, tags, it


def localize(focal, tag_poses, q_tag_idx, q_observed, q_mask, start,
             aruco_size: float, precision: str = "f64",
             max_iterations: int = 100, rtol: float = 1e-14):
    """Each query's pose (Q, 6) against fixed tags and focal, from
    ``start`` (Q, 6); the query's blocks are q_tag_idx (Q, K), q_observed
    (Q, K, 4, 2), q_mask (Q, K).  Returns the poses in the working dtype."""
    dt = dtype_of(precision)
    dev = start.device
    f = torch.as_tensor(focal, dtype=dt, device=dev).reshape(())
    tags = tag_poses.to(dt)
    q, k = q_tag_idx.shape
    obs = q_observed.to(dt).reshape(q * k, 4, 2)
    m = q_mask.reshape(q, k, 1)
    tq = tags[q_tag_idx.reshape(-1)]

    def res(pose, jac):
        out = project(f, pose.repeat_interleave(k, 0), tq, aruco_size,
                      precision, jacobians=jac)
        uv = out[0] if jac else out
        zero = torch.zeros((), dtype=dt, device=dev)
        r = torch.where(m, (uv - obs).reshape(q, k, 8), zero)
        if not jac:
            return r
        return r, torch.where(m[..., None], out[3].reshape(q, k, 8, 6), zero)

    pose = start.to(dt).clone()
    r = res(pose, False)
    cost = 0.5 * (r * r).sum((1, 2))
    lam = torch.full((q,), 1e-4, dtype=dt, device=dev)
    active = torch.ones(q, dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        r, j = res(pose, True)
        j2 = j.reshape(q, k * 8, 6)
        h = mm(j2.transpose(1, 2), j2, precision)
        g = mm(j2.transpose(1, 2), r.reshape(q, k * 8, 1), precision)[..., 0]
        d = torch.linalg.solve(_damp(h, lam[:, None]), -g)
        new_pose = pose + d
        r_new = res(new_pose, False)
        new = 0.5 * (r_new * r_new).sum((1, 2))
        keep = active & torch.isfinite(new) & (new < cost)
        done = keep & (cost - new <= rtol * new)
        pose = torch.where(keep[:, None], new_pose, pose)
        cost = torch.where(keep, new, cost)
        lam = torch.where(keep, (lam / 10.0).clamp(min=1e-12), lam * 10.0)
        active &= ~done & (lam < 1e16)
        if not bool(active.any()):
            break
    return pose
