"""Gauss–Newton normal equations with Schur elimination of tag blocks,
grouped dense path (port of ar_slam_tpu/solve/schur.py).

Tag 6x6 blocks are eliminated first, leaving a dense reduced system over
x = [camera(3), capture_0(6), capture_1(6), ...] (≙ ceres DENSE_SCHUR).
Blocks arrive TAG-GROUPED: row t*S+s of the (T*S) table belongs to tag t.
Tag-side sums are reshape-sums; capture-side sums gather the per-block
products into capture order and reshape-sum.  Both sum in a fixed order,
unlike ``index_add_``, whose atomics reorder sums from run to run on CUDA.

The flat layout and the implicit-Schur CG solver of the reference are not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import ar_slam_tpu_torch.device  # noqa: F401  (switches TF32 off)


def spd_inv(a, n: int):
    """Batched (..., n, n) SPD inverse by an unrolled modified Cholesky
    (every pivot floored at 1e-6 x the block's largest diagonal entry) ->
    triangular inverse -> L^-T L^-1; the reference's formula, so marginally
    indefinite float32 blocks degrade the same way."""
    diag_max = a[..., 0, 0]
    for i in range(1, n):
        diag_max = torch.maximum(diag_max, a[..., i, i])
    floor = 1e-6 * torch.abs(diag_max) + 1e-30
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.maximum(s, floor))
            else:
                L[i][j] = s / L[j][j]
    linv = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(j, n):
            if i == j:
                linv[i][j] = 1.0 / L[i][i]
            else:
                s = L[i][j] * linv[j][j]
                for k in range(j + 1, i):
                    s = s + L[i][k] * linv[k][j]
                linv[i][j] = -s / L[i][i]
    rows = []
    for i in range(n):
        cols = []
        for j in range(n):
            s = None
            for k in range(max(i, j), n):
                term = linv[k][i] * linv[k][j]
                s = term if s is None else s + term
            cols.append(s)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


class GroupedEqs(NamedTuple):
    """Normal-equation blocks in the capture-sparse tag-grouped layout;
    slot (t, s) of ``wt_s`` couples tag t with capture slot_cap[t*S+s]."""

    hcc: torch.Tensor  # (3, 3)
    hcp: torch.Tensor  # (C, 3, 6)
    hpp: torch.Tensor  # (C, 6, 6)
    hct: torch.Tensor  # (T, 3, 6)
    wt_s: torch.Tensor  # (T, S, 6, 6)
    htt: torch.Tensor  # (T, 6, 6)
    g_c: torch.Tensor  # (3,)
    g_p: torch.Tensor  # (C, 6)
    g_t: torch.Tensor  # (T, 6)


def group_blocks_by_tag(tag_idx, block_mask, n_tags: int, s_max: int):
    """Group a block table into (N, S) key slots: returns (gather (N*S,)
    source rows, mask (N*S,) bool).  Generic over the key (tags, or
    grouped capture indices for the capture-side permutation).  Blocks
    beyond ``s_max`` observations of one key are dropped; callers size
    s_max to the true maximum."""
    b = tag_idx.shape[0]
    dev = tag_idx.device
    key = torch.where(block_mask, tag_idx.to(torch.int64),
                      torch.full_like(tag_idx, n_tags, dtype=torch.int64))
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    pos = torch.arange(b, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]])
    start_pos = torch.cummax(torch.where(is_start, pos,
                                         torch.full_like(pos, -1)), 0).values
    slot = pos - start_pos
    valid = (sk < n_tags) & (slot < s_max)
    dest = torch.where(valid, sk * s_max + slot,
                       torch.full_like(sk, n_tags * s_max))
    # one spare slot takes every dropped row; it is cut off below
    gather = torch.zeros(n_tags * s_max + 1, dtype=torch.int64, device=dev)
    gather[dest] = order
    mask = torch.zeros(n_tags * s_max + 1, dtype=torch.bool, device=dev)
    mask[dest] = True
    gather[-1], mask[-1] = 0, False
    return gather[:-1], mask[:-1]


def _outer_rsum(a, b):
    """Per-block sum_r a[., r, i] b[., r, j] as broadcast-multiply + sum."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(dim=1)


def assemble_grouped(r, jc, jp, jt, cap_gather, cap_gmask, n_caps: int,
                     n_tags: int, s_max: int) -> GroupedEqs:
    """Normal equations from a tag-grouped (T*S, ...) block table."""
    dtype = r.dtype
    sc = cap_gather.shape[0] // n_caps
    mc = cap_gmask.to(dtype)
    hcc = torch.einsum("bri,brj->ij", jc, jc)
    g_c = torch.einsum("bri,br->i", jc, r)
    b_rows = r.shape[0]
    cat = torch.cat([
        _outer_rsum(jc, jp).reshape(b_rows, 18),
        _outer_rsum(jp, jp).reshape(b_rows, 36),
        (jp * r[:, :, None]).sum(dim=1),
    ], dim=1)  # (B, 60): one gather carries all three capture-side products
    per = (cat[cap_gather] * mc[:, None]).reshape(n_caps, sc, 60).sum(dim=1)
    hcp = per[:, :18].reshape(-1, 3, 6)
    hpp = per[:, 18:54].reshape(-1, 6, 6)
    g_p = per[:, 54:]

    lead = r.shape[0] // s_max
    jt_r = jt.reshape(lead, s_max * 8, 6)
    jc_r = jc.reshape(lead, s_max * 8, 3)
    r_r = r.reshape(lead, s_max * 8)
    hct = _outer_rsum(jc_r, jt_r)
    htt = _outer_rsum(jt_r, jt_r)
    g_t = (jt_r * r_r[:, :, None]).sum(dim=1)
    wt_s = _outer_rsum(jp, jt).reshape(lead, s_max, 6, 6)
    return GroupedEqs(hcc, hcp, hpp, hct, wt_s, htt, g_c, g_p, g_t)


def quad_form_grouped(eqs: GroupedEqs, slot_cap, d_cam, d_cap, d_tag):
    """(d^T g, d^T H d) straight from the assembled blocks — the LM step
    quality needs no per-block Jacobian table."""
    g_dot_d = (torch.dot(eqs.g_c, d_cam) + torch.sum(eqs.g_p * d_cap)
               + torch.sum(eqs.g_t * d_tag))
    lead, s_max = eqs.wt_s.shape[:2]
    dcap_s = d_cap[slot_cap].reshape(lead, s_max, 6)
    quad = (
        torch.einsum("ij,i,j->", eqs.hcc, d_cam, d_cam)
        + 2.0 * torch.einsum("cij,i,cj->", eqs.hcp, d_cam, d_cap)
        + torch.einsum("cij,ci,cj->", eqs.hpp, d_cap, d_cap)
        + 2.0 * torch.einsum("tij,i,tj->", eqs.hct, d_cam, d_tag)
        + 2.0 * torch.sum(eqs.wt_s * dcap_s[:, :, :, None]
                          * d_tag[:, None, None, :])
        + torch.einsum("tij,ti,tj->", eqs.htt, d_tag, d_tag)
    )
    return g_dot_d, quad


def _scale_and_damp_tags(hct, wt_s, slot_cap, htt, g_t, s_c, s_p, tag_active,
                         lam, jacobi_scaling: bool = True,
                         min_diag: float = 1e-6, max_diag: float = 1e32):
    """Jacobi-scale the coupling / tag blocks / tag gradients, damp V and
    batch-invert it.  Returns (hct_s, wt_ss, v_inv, g_t_scaled, s_t)."""
    dtype = htt.dtype
    lead, s_max = wt_s.shape[:2]
    tag_m = tag_active.to(dtype)
    d_t = torch.diagonal(htt, dim1=-2, dim2=-1)
    if jacobi_scaling:
        s_t = tag_m[:, None] / (1.0 + torch.sqrt(torch.clamp(d_t, min=0.0)))
    else:
        s_t = tag_m[:, None].expand_as(d_t)
    hct_s = hct * s_c[None, :, None] * s_t[:, None, :]
    sp_slot = s_p[slot_cap].reshape(lead, s_max, 6)
    wt_ss = wt_s * sp_slot[:, :, :, None] * s_t[:, None, None, :]
    htt = htt * s_t[:, :, None] * s_t[:, None, :]
    g_t = g_t * s_t
    dd_t = torch.clamp(torch.diagonal(htt, dim1=-2, dim2=-1), min_diag,
                       max_diag)
    eye6 = torch.eye(6, dtype=dtype, device=htt.device)
    htt = htt + lam * dd_t[:, :, None] * eye6
    htt = torch.where(tag_m[:, None, None] > 0, htt, eye6)
    return hct_s, wt_ss, spd_inv(htt, 6), g_t, s_t


def expand_coupling_slab(hct_s, wt_ss, slot_cap, n_caps: int):
    """The capture-sparse coupling as a dense (T, Nr, 6) slab (transient,
    for the dense reduced solve only): a {0,1} routing contraction."""
    n_tags, s_max = wt_ss.shape[:2]
    oc = (slot_cap.reshape(n_tags, s_max)[:, :, None]
          == torch.arange(n_caps, device=slot_cap.device)[None, None, :]
          ).to(wt_ss.dtype)
    wt_pp = torch.einsum("tsc,tsij->tcij", oc, wt_ss)
    return torch.cat([hct_s, wt_pp.reshape(n_tags, 6 * n_caps, 6)], dim=1)


def eliminate_tags_grouped(hct, wt_s, slot_cap, htt, g_t, s_c, s_p,
                           tag_active, lam, jacobi_scaling: bool = True,
                           min_diag: float = 1e-6, max_diag: float = 1e32):
    """Schur-eliminate the tag blocks.  Returns (wvw (Nr, Nr), wvg (Nr,),
    ctx) with ctx = (v_inv, hct_s, wt_ss, g_t_scaled, s_t) for back-
    substitution."""
    hct_s, wt_ss, v_inv, g_t, s_t = _scale_and_damp_tags(
        hct, wt_s, slot_cap, htt, g_t, s_c, s_p, tag_active, lam,
        jacobi_scaling, min_diag, max_diag)
    wt = expand_coupling_slab(hct_s, wt_ss, slot_cap, s_p.shape[0])
    y = torch.einsum("tnk,tkj->tnj", wt, v_inv)
    wvw = torch.einsum("tnk,tmk->nm", y, wt)
    wvg = torch.einsum("tnk,tk->n", y, g_t)
    return wvw, wvg, (v_inv, hct_s, wt_ss, g_t, s_t)


def cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling=True):
    """Camera/capture Jacobi scale vectors, s = mask / (1 + sqrt(diag))."""
    dtype = eqs.hcc.dtype
    cam_m = torch.as_tensor(cam_active, device=eqs.hcc.device).to(dtype)
    cap_m = cap_active.to(dtype)
    d_c = torch.diagonal(eqs.hcc)
    d_p = torch.diagonal(eqs.hpp, dim1=-2, dim2=-1)
    if jacobi_scaling:
        s_c = cam_m / (1.0 + torch.sqrt(torch.clamp(d_c, min=0.0)))
        s_p = cap_m[:, None] / (1.0 + torch.sqrt(torch.clamp(d_p, min=0.0)))
    else:
        s_c = cam_m.expand(d_c.shape)
        s_p = cap_m[:, None].expand(d_p.shape)
    return s_c, s_p


def reduced_solve(eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg,
                  min_diag: float = 1e-6, max_diag: float = 1e32):
    """Assemble and Cholesky-solve the damped reduced camera system
    S = A - sum(wvw).  A failed factorization yields NaN (a rejected step),
    as the reference's cho_factor does."""
    dtype = eqs.hcc.dtype
    dev = eqs.hcc.device
    c = eqs.hpp.shape[0]
    nr = 3 + 6 * c
    cam_m = torch.as_tensor(cam_active, device=dev).to(dtype)
    cap_m = cap_active.to(dtype)
    hcc = eqs.hcc * s_c[:, None] * s_c[None, :]
    hcp = eqs.hcp * s_c[None, :, None] * s_p[:, None, :]
    hpp = eqs.hpp * s_p[:, :, None] * s_p[:, None, :]
    g_c = eqs.g_c * s_c
    g_p = eqs.g_p * s_p
    dd_c = torch.clamp(torch.diagonal(hcc), min_diag, max_diag)
    dd_p = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), min_diag,
                       max_diag)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    hcc = hcc + lam * torch.diag(dd_c)
    hpp = hpp + lam * dd_p[:, :, None] * eye6

    a = torch.zeros((nr, nr), dtype=dtype, device=dev)
    a[0:3, 0:3] = hcc
    hcp_flat = hcp.permute(1, 0, 2).reshape(3, 6 * c)
    a[0:3, 3:] = hcp_flat
    a[3:, 0:3] = hcp_flat.T
    a[3:, 3:].view(c, 6, c, 6).diagonal(dim1=0, dim2=2).copy_(
        hpp.permute(1, 2, 0))
    s_mat = a - wvw
    rhs = -torch.cat([g_c, g_p.reshape(-1)]) + wvg
    # identity rows for inactive reduced parameters keep Cholesky well-posed
    m_r = torch.cat([cam_m.expand(3), cap_m.repeat_interleave(6)])
    s_mat = s_mat * m_r[:, None] * m_r[None, :] + torch.diag(1.0 - m_r)
    rhs = rhs * m_r
    chol, info = torch.linalg.cholesky_ex(s_mat)
    delta_r = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    delta_r = torch.where(info == 0, delta_r,
                          torch.full_like(delta_r, float("nan")))
    delta_r = delta_r * m_r
    delta_cam = delta_r[0:3] * s_c
    delta_cap = delta_r[3:].reshape(c, 6) * s_p
    return delta_r, delta_cam, delta_cap


def backsub_tags_sparse(v_inv, hct_s, wt_ss, slot_cap, g_t_scaled, s_t,
                        tag_active, delta_r):
    """delta_t = -V^-1 (g_t + W^T delta_r) from the capture-sparse
    coupling."""
    lead, s_max = wt_ss.shape[:2]
    tag_m = tag_active.to(v_inv.dtype)
    dc = delta_r[:3]
    dp = delta_r[3:].reshape(-1, 6)
    wtd = torch.einsum("tik,i->tk", hct_s, dc)
    per_slot = (wt_ss.reshape(lead * s_max, 6, 6)
                * dp[slot_cap][:, :, None]).sum(dim=1)
    wtd = wtd + per_slot.reshape(lead, s_max, 6).sum(dim=1)
    delta_t = -torch.einsum("tkj,tj->tk", v_inv, g_t_scaled + wtd) * tag_m[
        :, None]
    return delta_t * s_t


def schur_solve_grouped(eqs: GroupedEqs, slot_cap, lam, cam_active,
                        cap_active, tag_active, jacobi_scaling: bool = True,
                        min_diag: float = 1e-6, max_diag: float = 1e32):
    """Solve (H + lam clamp(diag)) delta = -g over the grouped layout:
    returns (delta_cam (3,), delta_cap (C, 6), delta_tag (T, 6))."""
    s_c, s_p = cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling)
    wvw, wvg, ctx = eliminate_tags_grouped(
        eqs.hct, eqs.wt_s, slot_cap, eqs.htt, eqs.g_t, s_c, s_p, tag_active,
        lam, jacobi_scaling, min_diag, max_diag)
    delta_r, delta_cam, delta_cap = reduced_solve(
        eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg, min_diag,
        max_diag)
    v_inv, hct_s, wt_ss, g_t_s, s_t = ctx
    delta_tag = backsub_tags_sparse(v_inv, hct_s, wt_ss, slot_cap, g_t_s,
                                    s_t, tag_active, delta_r)
    return delta_cam, delta_cap, delta_tag
