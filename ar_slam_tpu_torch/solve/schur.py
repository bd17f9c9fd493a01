"""Gauss–Newton normal equations with Schur elimination of tag blocks
(port of ar_slam_tpu/solve/schur.py).

Tag 6x6 blocks are eliminated first, leaving a reduced system over
x = [camera(3), capture_0(6), capture_1(6), ...] of length Nr = 3 + 6C.
Three solvers share the scaling and damping conventions:

- grouped dense (``schur_solve_grouped``, ≙ ceres DENSE_SCHUR): blocks
  arrive TAG-GROUPED, row t*S+s of the (T*S) table belonging to tag t;
  tag-side sums are reshape-sums, capture-side sums gather the per-block
  products into capture order and reshape-sum.  Both sum in a fixed order,
  unlike ``index_add_``, whose atomics reorder sums from run to run on
  CUDA.  The dense reduced system is Cholesky-solved.
- grouped CG (``schur_solve_grouped_cg``, ≙ ITERATIVE_SCHUR): the same
  layout, optionally ROW-SPLIT (``TagRows``), with preconditioned CG on an
  implicit Schur complement; nothing dense in tags x captures is built, so
  a 10k-tag / 4k-capture map fits.  CG runs a fixed number of steps with
  the converged state frozen on the device, so it reads nothing back.
  ``schur_solve_sharded_cg`` runs it with the tags split into shards
  (the tag-sharded distributed solve, parallel/dist_lm.py).
- flat (``assemble`` / ``schur_solve``): segment sums over the block
  table and a dense (6C, 6T) coupling; for ``lm_solve`` without
  observation bounds and custom ``assemble_fn`` hooks.
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


def _cam_mask(cam_active, like: torch.Tensor) -> torch.Tensor:
    """The camera's active flag as a 0-dim tensor of ``like``'s dtype and
    device.  A Python bool becomes a fill, not a host-to-device copy (which
    would synchronise the card)."""
    if isinstance(cam_active, torch.Tensor):
        return cam_active.to(device=like.device, dtype=like.dtype)
    return torch.full((), float(cam_active), dtype=like.dtype,
                      device=like.device)


class NormalEqs(NamedTuple):
    """Assembled blocks of J^T J and J^T r (flat layout), before damping
    and scaling."""

    hcc: torch.Tensor  # (3, 3) cam-cam
    hcp: torch.Tensor  # (C, 3, 6) cam-cap
    hpp: torch.Tensor  # (C, 6, 6) cap-cap diagonal blocks
    hct: torch.Tensor  # (T, 3, 6) cam-tag
    hpt: torch.Tensor  # (6C, 6T) cap-tag coupling, dense
    htt: torch.Tensor  # (T, 6, 6) tag-tag diagonal blocks
    g_c: torch.Tensor  # (3,)
    g_p: torch.Tensor  # (C, 6)
    g_t: torch.Tensor  # (T, 6)


class CapEqs(NamedTuple):
    """Camera/capture-side blocks only."""

    hcc: torch.Tensor  # (3, 3)
    hcp: torch.Tensor  # (C, 3, 6)
    hpp: torch.Tensor  # (C, 6, 6)
    g_c: torch.Tensor  # (3,)
    g_p: torch.Tensor  # (C, 6)


def _outer_rsum(a, b):
    """Per-block sum_r a[., r, i] b[., r, j] as broadcast-multiply + sum."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(dim=1)


def _segment_sum(x, idx, n: int):
    """sum of the rows of ``x`` per index into (n, ...)."""
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)


def assemble_cap_side(r, jc, jp, cap_idx, n_caps) -> CapEqs:
    """Camera/capture blocks of J^T J and J^T r from a flat block table."""
    hcc = _outer_rsum(jc, jc).sum(dim=0)
    hcp = _segment_sum(_outer_rsum(jc, jp), cap_idx, n_caps)
    hpp = _segment_sum(_outer_rsum(jp, jp), cap_idx, n_caps)
    g_c = (jc * r[:, :, None]).sum(dim=(0, 1))
    g_p = _segment_sum((jp * r[:, :, None]).sum(dim=1), cap_idx, n_caps)
    return CapEqs(hcc, hcp, hpp, g_c, g_p)


def assemble_tag_side(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags):
    """Tag-indexed blocks (hct, hpt, htt, g_t) from a flat block table;
    each (capture, tag) pair is one block, so the coupling is a plain
    scatter-add into the flat (6C, 6T) matrix."""
    hct = _segment_sum(_outer_rsum(jc, jt), tag_idx, n_tags)
    hpt_b = _outer_rsum(jp, jt)  # (B, 6, 6)
    six = torch.arange(6, device=r.device)
    rows = cap_idx.to(torch.int64)[:, None, None] * 6 + six[None, :, None]
    cols = tag_idx.to(torch.int64)[:, None, None] * 6 + six[None, None, :]
    flat = (rows * (6 * n_tags) + cols).expand(hpt_b.shape).reshape(-1)
    hpt = hpt_b.new_zeros(36 * n_caps * n_tags).index_add_(
        0, flat, hpt_b.reshape(-1)).reshape(6 * n_caps, 6 * n_tags)
    htt = _segment_sum(_outer_rsum(jt, jt), tag_idx, n_tags)
    g_t = _segment_sum((jt * r[:, :, None]).sum(dim=1), tag_idx, n_tags)
    return hct, hpt, htt, g_t


def assemble(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags) -> NormalEqs:
    """Segment-reduce the per-block Jacobian products into H blocks."""
    cap = assemble_cap_side(r, jc, jp, cap_idx, n_caps)
    hct, hpt, htt, g_t = assemble_tag_side(r, jc, jp, jt, cap_idx, tag_idx,
                                           n_caps, n_tags)
    return NormalEqs(cap.hcc, cap.hcp, cap.hpp, hct, hpt, htt, cap.g_c,
                     cap.g_p, g_t)


class GroupedEqs(NamedTuple):
    """Normal-equation blocks in the capture-sparse tag-grouped layout;
    slot (t, s) of ``wt_s`` couples tag (or split row) t with capture
    slot_cap[t*S+s]."""

    hcc: torch.Tensor  # (3, 3)
    hcp: torch.Tensor  # (C, 3, 6)
    hpp: torch.Tensor  # (C, 6, 6)
    hct: torch.Tensor  # (T, 3, 6)
    wt_s: torch.Tensor  # (T, S, 6, 6), or (R, S_row, 6, 6) row-split
    htt: torch.Tensor  # (T, 6, 6)
    g_c: torch.Tensor  # (3,)
    g_p: torch.Tensor  # (C, 6)
    g_t: torch.Tensor  # (T, 6)


def _sorted_slots(key_idx, block_mask, n_keys: int):
    """Blocks sorted by key (stable; masked blocks last): (order, sorted
    keys with n_keys for masked blocks, each block's rank in its key)."""
    b = key_idx.shape[0]
    dev = key_idx.device
    key = torch.where(block_mask, key_idx.to(torch.int64),
                      torch.full((), n_keys, dtype=torch.int64, device=dev))
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    pos = torch.arange(b, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]])
    start_pos = torch.cummax(torch.where(is_start, pos,
                                         torch.full_like(pos, -1)), 0).values
    return order, sk, pos - start_pos


def _scatter_slots(dest, order, n_slots: int):
    """(gather, mask) of n_slots slots from each block's destination; a
    destination of n_slots is dropped (one spare slot takes every dropped
    row and is cut off, so no index is out of range on the card)."""
    dev = dest.device
    gather = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    gather[dest] = order
    # index_fill_, not mask[dest] = True: the Python scalar would be
    # copied to the card, a synchronising copy
    mask = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    mask.index_fill_(0, dest, True)
    return gather[:-1], mask[:-1]


def group_blocks_by_tag(tag_idx, block_mask, n_tags: int, s_max: int):
    """Group a block table into (N, S) key slots: returns (gather (N*S,)
    source rows, mask (N*S,) bool).  Generic over the key (tags, or
    grouped capture indices for the capture-side permutation).  Blocks
    beyond ``s_max`` observations of one key are dropped; callers size
    s_max to the true maximum."""
    order, sk, slot = _sorted_slots(tag_idx, block_mask, n_tags)
    valid = (sk < n_tags) & (slot < s_max)
    dest = torch.where(valid, sk * s_max + slot,
                       torch.full_like(sk, n_tags * s_max))
    return _scatter_slots(dest, order, n_tags * s_max)


class TagRows(NamedTuple):
    """ROW-SPLIT layout: the slot table is (R, S_row) with a tag spanning
    ceil(obs_t / S_row) consecutive rows instead of one (T, S_max) row per
    tag, so padding follows the mean observation count, not the largest.
    Per-tag quantities stay (T, ...); per-row partial sums reduce to tags
    by gathering each tag's <= max_rows rows (``rows_to_tags``).

      row_tag: (R,) owning tag per row, clipped to [0, T-1]
      row_valid: (R,) bool
      tag_rows: (T, max_rows) row ids per tag (clipped in range)
      tag_rows_mask: (T, max_rows) bool
    """

    row_tag: torch.Tensor
    row_valid: torch.Tensor
    tag_rows: torch.Tensor
    tag_rows_mask: torch.Tensor


def group_blocks_by_tag_rows(tag_idx, block_mask, n_tags: int, s_row: int,
                             n_rows: int, max_rows: int):
    """Row-split ``group_blocks_by_tag``: each tag's k-th observation goes
    to row ``row_base[tag] + k // s_row``, slot ``k % s_row``.  Returns
    (gather (n_rows*s_row,), mask, TagRows).  Blocks overflowing the
    ``n_rows`` budget are dropped: callers size n_rows >= sum_t
    ceil(obs_t / s_row) and max_rows >= ceil(max_t obs_t / s_row).  Reads
    nothing back to the host."""
    dev = tag_idx.device
    order, sk, slot_in_tag = _sorted_slots(tag_idx, block_mask, n_tags)
    # one spare bin counts the masked blocks and is cut off
    counts = torch.zeros(n_tags + 1, dtype=torch.int64, device=dev)
    counts = counts.index_add_(0, sk, torch.ones_like(sk))[:n_tags]
    rows_per = (counts + (s_row - 1)) // s_row
    row_base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(rows_per, 0)])  # (T+1,)
    dest_row = row_base[torch.clamp(sk, 0, n_tags - 1)] + slot_in_tag // s_row
    valid = (sk < n_tags) & (dest_row < n_rows)
    dest = torch.where(valid, dest_row * s_row + slot_in_tag % s_row,
                       torch.full_like(sk, n_rows * s_row))
    gather, mask = _scatter_slots(dest, order, n_rows * s_row)
    r_ids = torch.arange(n_rows, device=dev)
    row_tag = torch.searchsorted(row_base[1:].contiguous(), r_ids, right=True)
    row_valid = r_ids < row_base[n_tags]
    row_tag = torch.clamp(row_tag, 0, n_tags - 1)
    mr = torch.arange(max_rows, device=dev)
    tag_rows_mask = mr[None, :] < rows_per[:, None]
    tag_rows = torch.clamp(row_base[:n_tags, None] + mr[None, :], 0,
                           n_rows - 1)
    return gather, mask, TagRows(row_tag, row_valid, tag_rows, tag_rows_mask)


def rows_to_tags(x_rows, rows: TagRows):
    """Sum per-row values (R, ...) into their tags (T, ...) by gathering
    each tag's <= max_rows rows and summing: no scatter."""
    g = x_rows[rows.tag_rows]  # (T, max_rows, ...)
    m = rows.tag_rows_mask
    m = m.reshape(m.shape + (1,) * (g.ndim - 2)).to(x_rows.dtype)
    return (g * m).sum(dim=1)


def tags_to_rows(x_tags, rows: TagRows):
    """Per-tag values (T, ...) expanded to rows (R, ...); padding rows read
    tag 0, always multiplied by the zero coupling of their slots."""
    return x_tags[rows.row_tag]


def assemble_grouped(r, jc, jp, jt, cap_gather, cap_gmask, n_caps: int,
                     n_tags: int, s_max: int, rows: TagRows | None = None,
                     cap_rows: TagRows | None = None) -> GroupedEqs:
    """Normal equations from a tag-grouped (T*S, ...) block table, or a
    row-split (R*S_row, ...) one with ``rows``; ``cap_rows`` row-splits
    the capture-grouped permutation the same way."""
    dtype = r.dtype
    lead_c = n_caps if cap_rows is None else cap_rows.row_tag.shape[0]
    sc = cap_gather.shape[0] // lead_c
    mc = cap_gmask.to(dtype)
    hcc = torch.einsum("bri,brj->ij", jc, jc)
    g_c = torch.einsum("bri,br->i", jc, r)
    b_rows = r.shape[0]
    cat = torch.cat([
        _outer_rsum(jc, jp).reshape(b_rows, 18),
        _outer_rsum(jp, jp).reshape(b_rows, 36),
        (jp * r[:, :, None]).sum(dim=1),
    ], dim=1)  # (B, 60): one gather carries all three capture-side products
    per = (cat[cap_gather] * mc[:, None]).reshape(lead_c, sc, 60).sum(dim=1)
    if cap_rows is not None:
        per = rows_to_tags(per, cap_rows)
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
    if rows is not None:
        hct = rows_to_tags(hct, rows)
        htt = rows_to_tags(htt, rows)
        g_t = rows_to_tags(g_t, rows)
    wt_s = _outer_rsum(jp, jt).reshape(lead, s_max, 6, 6)
    return GroupedEqs(hcc, hcp, hpp, hct, wt_s, htt, g_c, g_p, g_t)


def quad_form_flat(eqs: NormalEqs, d_cam, d_cap, d_tag):
    """(d^T g, d^T H d) from the flat blocks — the LM step quality needs
    no per-block Jacobian table."""
    g_dot_d = (torch.dot(eqs.g_c, d_cam) + torch.sum(eqs.g_p * d_cap)
               + torch.sum(eqs.g_t * d_tag))
    quad = (
        torch.einsum("ij,i,j->", eqs.hcc, d_cam, d_cam)
        + 2.0 * torch.einsum("cij,i,cj->", eqs.hcp, d_cam, d_cap)
        + torch.einsum("cij,ci,cj->", eqs.hpp, d_cap, d_cap)
        + 2.0 * torch.einsum("tij,i,tj->", eqs.hct, d_cam, d_tag)
        + 2.0 * torch.dot(d_cap.reshape(-1),
                          eqs.hpt @ d_tag.reshape(-1))
        + torch.einsum("tij,ti,tj->", eqs.htt, d_tag, d_tag)
    )
    return g_dot_d, quad


def quad_form_cap_side(hcc, hcp, hpp, g_c, g_p, d_cam, d_cap):
    """Camera/capture contribution to (d^T g, d^T H d)."""
    g_dot_d = torch.dot(g_c, d_cam) + torch.sum(g_p * d_cap)
    quad = (torch.einsum("ij,i,j->", hcc, d_cam, d_cam)
            + 2.0 * torch.einsum("cij,i,cj->", hcp, d_cam, d_cap)
            + torch.einsum("cij,ci,cj->", hpp, d_cap, d_cap))
    return g_dot_d, quad


def quad_form_tag_side(hct, wt_s, htt, g_t, slot_cap, d_cam, d_cap, d_tag,
                       rows: TagRows | None = None):
    """Tag-indexed contribution to (d^T g, d^T H d); padding slots carry
    zero coupling blocks, so their capture / tag reads add nothing."""
    lead, s_max = wt_s.shape[:2]
    d_tag_rows = d_tag if rows is None else tags_to_rows(d_tag, rows)
    dcap_s = d_cap[slot_cap].reshape(lead, s_max, 6)
    g_dot_d = torch.sum(g_t * d_tag)
    quad = (2.0 * torch.einsum("tij,i,tj->", hct, d_cam, d_tag)
            + 2.0 * torch.sum(wt_s * dcap_s[:, :, :, None]
                              * d_tag_rows[:, None, None, :])
            + torch.einsum("tij,ti,tj->", htt, d_tag, d_tag))
    return g_dot_d, quad


def quad_form_grouped(eqs: GroupedEqs, slot_cap, d_cam, d_cap, d_tag,
                      rows: TagRows | None = None):
    """(d^T g, d^T H d) for the grouped layout: the two sides summed."""
    gd_c, q_c = quad_form_cap_side(eqs.hcc, eqs.hcp, eqs.hpp, eqs.g_c,
                                   eqs.g_p, d_cam, d_cap)
    gd_t, q_t = quad_form_tag_side(eqs.hct, eqs.wt_s, eqs.htt, eqs.g_t,
                                   slot_cap, d_cam, d_cap, d_tag, rows=rows)
    return gd_c + gd_t, q_c + q_t


def _tag_scales(htt, tag_active, jacobi_scaling: bool):
    """Per-tag Jacobi scales with the active mask folded in, and the mask."""
    tag_m = tag_active.to(htt.dtype)
    d_t = torch.diagonal(htt, dim1=-2, dim2=-1)
    if jacobi_scaling:
        s_t = tag_m[:, None] / (1.0 + torch.sqrt(torch.clamp(d_t, min=0.0)))
    else:
        s_t = tag_m[:, None].expand_as(d_t)
    return s_t, tag_m


def _damped_v_inv(htt, s_t, tag_m, lam, min_diag, max_diag):
    """Scale, damp and batch-invert the tag blocks (inactive tags get the
    identity, so the inverse stays finite)."""
    htt = htt * s_t[:, :, None] * s_t[:, None, :]
    dd_t = torch.clamp(torch.diagonal(htt, dim1=-2, dim2=-1), min_diag,
                       max_diag)
    eye6 = torch.eye(6, dtype=htt.dtype, device=htt.device)
    htt = htt + lam * dd_t[:, :, None] * eye6
    htt = torch.where(tag_m[:, None, None] > 0, htt, eye6)
    return spd_inv(htt, 6)


def _scale_and_damp_tags(hct, wt_s, slot_cap, htt, g_t, s_c, s_p, tag_active,
                         lam, jacobi_scaling: bool = True,
                         min_diag: float = 1e-6, max_diag: float = 1e32,
                         rows: TagRows | None = None):
    """Jacobi-scale the coupling / tag blocks / tag gradients, damp V and
    batch-invert it.  Returns (hct_s, wt_ss, v_inv, g_t_scaled, s_t); with
    ``rows`` the coupling table is row-split, the rest stays per tag."""
    lead, s_max = wt_s.shape[:2]
    s_t, tag_m = _tag_scales(htt, tag_active, jacobi_scaling)
    hct_s = hct * s_c[None, :, None] * s_t[:, None, :]
    sp_slot = s_p[slot_cap].reshape(lead, s_max, 6)
    s_t_rows = s_t if rows is None else tags_to_rows(s_t, rows)
    wt_ss = wt_s * sp_slot[:, :, :, None] * s_t_rows[:, None, None, :]
    v_inv = _damped_v_inv(htt, s_t, tag_m, lam, min_diag, max_diag)
    return hct_s, wt_ss, v_inv, g_t * s_t, s_t


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


def eliminate_tags(hct, hpt, htt, g_t, s_c, s_p, tag_active, lam,
                   jacobi_scaling: bool = True,
                   min_diag: float = 1e-6, max_diag: float = 1e32):
    """Schur-eliminate the tag blocks from the flat (6C, 6T) coupling.
    Returns (wvw (Nr, Nr), wvg (Nr,), v_inv, wt (T, Nr, 6), g_t_scaled,
    s_t); the last four feed ``backsub_tags``."""
    t = htt.shape[0]
    nr = 3 + s_p.numel()
    s_t, tag_m = _tag_scales(htt, tag_active, jacobi_scaling)
    hct = hct * s_c[None, :, None] * s_t[:, None, :]
    hpt = hpt * s_p.reshape(-1)[:, None] * s_t.reshape(-1)[None, :]
    v_inv = _damped_v_inv(htt, s_t, tag_m, lam, min_diag, max_diag)
    g_t = g_t * s_t
    w_cam = hct.permute(1, 0, 2).reshape(3, 6 * t)
    w = torch.cat([w_cam, hpt], dim=0)  # (Nr, 6T)
    wt = w.reshape(nr, t, 6).permute(1, 0, 2)  # (T, Nr, 6)
    y = torch.einsum("tnk,tkj->tnj", wt, v_inv)
    wvw = torch.einsum("tnk,tmk->nm", y, wt)
    wvg = torch.einsum("tnk,tk->n", y, g_t)
    return wvw, wvg, v_inv, wt, g_t, s_t


def cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling=True):
    """Camera/capture Jacobi scale vectors, s = mask / (1 + sqrt(diag))."""
    cam_m = _cam_mask(cam_active, eqs.hcc)
    cap_m = cap_active.to(eqs.hcc.dtype)
    d_c = torch.diagonal(eqs.hcc)
    d_p = torch.diagonal(eqs.hpp, dim1=-2, dim2=-1)
    if jacobi_scaling:
        s_c = cam_m / (1.0 + torch.sqrt(torch.clamp(d_c, min=0.0)))
        s_p = cap_m[:, None] / (1.0 + torch.sqrt(torch.clamp(d_p, min=0.0)))
    else:
        s_c = cam_m.expand(d_c.shape)
        s_p = cap_m[:, None].expand(d_p.shape)
    return s_c, s_p


def _reduced_blocks(eqs, s_c, s_p, cam_active, cap_active, lam, min_diag,
                    max_diag):
    """The scaled, damped camera/capture blocks and gradients, and the
    reduced-vector mask m_r (3 + 6C,): (hcc, hcp, hpp, g_c, g_p, cam_m,
    cap_m, m_r)."""
    c = eqs.hpp.shape[0]
    cam_m = _cam_mask(cam_active, eqs.hcc)
    cap_m = cap_active.to(eqs.hcc.dtype)
    hcc = eqs.hcc * s_c[:, None] * s_c[None, :]
    hcp = eqs.hcp * s_c[None, :, None] * s_p[:, None, :]
    hpp = eqs.hpp * s_p[:, :, None] * s_p[:, None, :]
    g_c = eqs.g_c * s_c
    g_p = eqs.g_p * s_p
    dd_c = torch.clamp(torch.diagonal(hcc), min_diag, max_diag)
    dd_p = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), min_diag,
                       max_diag)
    eye6 = torch.eye(6, dtype=hpp.dtype, device=hpp.device)
    hcc = hcc + lam * torch.diag(dd_c)
    hpp = hpp + lam * dd_p[:, :, None] * eye6
    m_r = torch.cat([cam_m.expand(3), cap_m[:, None].expand(c, 6).reshape(-1)])
    return hcc, hcp, hpp, g_c, g_p, cam_m, cap_m, m_r


def reduced_solve(eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg,
                  min_diag: float = 1e-6, max_diag: float = 1e32):
    """Assemble and Cholesky-solve the damped reduced camera system
    S = A - sum(wvw).  A failed factorization yields NaN (a rejected step),
    as the reference's cho_factor does."""
    c = eqs.hpp.shape[0]
    nr = 3 + 6 * c
    hcc, hcp, hpp, g_c, g_p, _, _, m_r = _reduced_blocks(
        eqs, s_c, s_p, cam_active, cap_active, lam, min_diag, max_diag)
    a = torch.zeros((nr, nr), dtype=hcc.dtype, device=hcc.device)
    a[0:3, 0:3] = hcc
    hcp_flat = hcp.permute(1, 0, 2).reshape(3, 6 * c)
    a[0:3, 3:] = hcp_flat
    a[3:, 0:3] = hcp_flat.T
    a[3:, 3:].view(c, 6, c, 6).diagonal(dim1=0, dim2=2).copy_(
        hpp.permute(1, 2, 0))
    s_mat = a - wvw
    rhs = -torch.cat([g_c, g_p.reshape(-1)]) + wvg
    # identity rows for inactive reduced parameters keep Cholesky well-posed
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
                        tag_active, delta_r, rows: TagRows | None = None):
    """delta_t = -V^-1 (g_t + W^T delta_r) from the capture-sparse
    coupling (row-split with ``rows``)."""
    lead, s_max = wt_ss.shape[:2]
    tag_m = tag_active.to(v_inv.dtype)
    dc = delta_r[:3]
    dp = delta_r[3:].reshape(-1, 6)
    wtd = torch.einsum("tik,i->tk", hct_s, dc)
    per_slot = (wt_ss.reshape(lead * s_max, 6, 6)
                * dp[slot_cap][:, :, None]).sum(dim=1)
    per_row = per_slot.reshape(lead, s_max, 6).sum(dim=1)
    wtd = wtd + (per_row if rows is None else rows_to_tags(per_row, rows))
    delta_t = -torch.einsum("tkj,tj->tk", v_inv, g_t_scaled + wtd) * tag_m[
        :, None]
    return delta_t * s_t


def backsub_tags(v_inv, wt, g_t_scaled, s_t, tag_active, delta_r):
    """delta_t = -V^-1 (g_t + W^T delta_r) from the dense (T, Nr, 6) W."""
    tag_m = tag_active.to(v_inv.dtype)
    wtd = torch.einsum("tnk,n->tk", wt, delta_r)
    delta_t = -torch.einsum("tkj,tj->tk", v_inv, g_t_scaled + wtd) * tag_m[
        :, None]
    return delta_t * s_t


def schur_solve(eqs: NormalEqs, lam, cam_active, cap_active, tag_active,
                jacobi_scaling: bool = True,
                min_diag: float = 1e-6, max_diag: float = 1e32):
    """Solve (H + lam clamp(diag)) delta = -g over the flat layout: returns
    (delta_cam (3,), delta_cap (C, 6), delta_tag (T, 6))."""
    s_c, s_p = cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling)
    wvw, wvg, v_inv, wt, g_t_s, s_t = eliminate_tags(
        eqs.hct, eqs.hpt, eqs.htt, eqs.g_t, s_c, s_p, tag_active, lam,
        jacobi_scaling, min_diag, max_diag)
    delta_r, delta_cam, delta_cap = reduced_solve(
        eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg, min_diag,
        max_diag)
    delta_tag = backsub_tags(v_inv, wt, g_t_s, s_t, tag_active, delta_r)
    return delta_cam, delta_cap, delta_tag


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


def _cap_scatter(per_slot, cap_gather, cap_gmask, n_caps: int,
                 cap_rows: TagRows | None = None):
    """Sum per-slot values (lead*S, ...) into their captures (C, ...)
    through the capture-grouped permutation (capture-row-split with
    ``cap_rows``): gathers and reshape-sums, no scatter."""
    lead_c = n_caps if cap_rows is None else cap_rows.row_tag.shape[0]
    sc = cap_gather.shape[0] // lead_c
    trailing = per_slot.shape[1:]
    mc = cap_gmask.to(per_slot.dtype)
    g = per_slot[cap_gather] * mc.reshape((-1,) + (1,) * len(trailing))
    per = g.reshape((lead_c, sc) + trailing).sum(dim=1)
    return per if cap_rows is None else rows_to_tags(per, cap_rows)


def preconditioned_cg(matvec, b, x0, precond, tol: float, maxiter: int):
    """``jax.scipy.sparse.linalg.cg`` with a preconditioner: the same
    iteration and stop test (||r||^2 <= tol^2 ||b||^2, at most ``maxiter``
    steps), run for exactly ``maxiter`` steps with the state frozen once
    the test holds, so it never reads a value back to the host.  The
    frozen steps' values (a 0/0 once r = 0 among them) are discarded by
    ``torch.where``."""
    atol2 = tol * tol * torch.dot(b, b)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = z = precond(r)
    gamma = torch.dot(r, z)
    for _ in range(maxiter):
        go = torch.dot(r, r) > atol2
        ap = matvec(p)
        alpha = gamma / torch.dot(p, ap)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        z_n = precond(r_n)
        gamma_n = torch.dot(r_n, z_n)
        p_n = z_n + (gamma_n / gamma) * p
        x = torch.where(go, x_n, x)
        r = torch.where(go, r_n, r)
        gamma = torch.where(go, gamma_n, gamma)
        p = torch.where(go, p_n, p)
    return x


class CgShard(NamedTuple):
    """One shard's tag side for ``schur_solve_sharded_cg``: its grouped
    tag blocks, slot tables and tag activity (a single-device solve is
    one shard holding every tag)."""

    hct: torch.Tensor
    wt_s: torch.Tensor
    htt: torch.Tensor
    g_t: torch.Tensor
    slot_cap: torch.Tensor
    cap_gather: torch.Tensor
    cap_gmask: torch.Tensor
    tag_active: torch.Tensor
    rows: TagRows | None = None
    cap_rows: TagRows | None = None


def _cg_shard_ops(sh: CgShard, s_c, s_p, lam, c: int, jacobi_scaling,
                  min_diag, max_diag):
    """One shard's part of the implicit Schur complement, on its device:
    (downdate, setup, backsub) with downdate(v) = W V^-1 W^T v (3 + 6C,)
    for this shard's tags, setup = [W V^-1 g_t (cam, cap), the
    preconditioner's diagonal corrections (cam, cap)] and backsub(delta_r)
    this shard's tag steps.  The first two are additive over shards."""
    dev = sh.hct.device
    s_c, s_p = s_c.to(dev), s_p.to(dev)
    lam = lam.to(dev) if isinstance(lam, torch.Tensor) else lam
    rows, cap_rows = sh.rows, sh.cap_rows
    lead, s_max = sh.wt_s.shape[:2]  # (T, S_max) or row-split (R, S_row)
    hct_s, wt_ss, v_inv, g_t_s, s_t = _scale_and_damp_tags(
        sh.hct, sh.wt_s, sh.slot_cap, sh.htt, sh.g_t, s_c, s_p,
        sh.tag_active, lam, jacobi_scaling, min_diag, max_diag, rows=rows)
    wt_flat = wt_ss.reshape(lead * s_max, 6, 6)

    def per_tag_sum(per_row):
        return per_row if rows is None else rows_to_tags(per_row, rows)

    def per_slot_of_tag(per_tag):
        """(T, ...) -> (lead*S, ...): each tag's (or row's) value on every
        one of its slots."""
        x = per_tag if rows is None else tags_to_rows(per_tag, rows)
        return x[:, None].expand((lead, s_max) + x.shape[1:]).reshape(
            (lead * s_max,) + x.shape[1:])

    def wt_v(vc, vp):
        """W^T v per tag: (T, 6) = hct^T vc + sum_s wt^T vp[cap(slot)]."""
        u = torch.einsum("tik,i->tk", hct_s, vc)
        u_slots = (wt_flat * vp[sh.slot_cap][:, :, None]).sum(dim=1)
        return u + per_tag_sum(u_slots.reshape(lead, s_max, 6).sum(dim=1))

    def w_z(z):
        """W z as (cam (3,), cap (C, 6))."""
        out_c = torch.einsum("tik,tk->i", hct_s, z)
        per_slot = (wt_flat * per_slot_of_tag(z)[:, None, :]).sum(dim=2)
        return out_c, _cap_scatter(per_slot, sh.cap_gather, sh.cap_gmask, c,
                                   cap_rows)

    def downdate(vm):
        vm = vm.to(dev)
        z = torch.einsum("tkj,tj->tk", v_inv,
                         wt_v(vm[:3], vm[3:].reshape(c, 6)))
        down_c, down_p = w_z(z)
        return torch.cat([down_c, down_p.reshape(-1)])

    # the rhs downdate W V^-1 g_t and the preconditioner's diagonal
    # corrections
    wvg_c, wvg_p = w_z(torch.einsum("tkj,tj->tk", v_inv, g_t_s))
    dg_c = torch.einsum("tik,tkl,tjl->ij", hct_s, v_inv, hct_s)
    v_inv_slot = per_slot_of_tag(v_inv)
    # wt . v_inv . wt^T per slot, as two broadcast-reduces
    a_slot = (wt_flat[:, :, :, None] * v_inv_slot[:, None, :, :]).sum(dim=2)
    dg_slot = (a_slot[:, :, None, :] * wt_flat[:, None, :, :]).sum(dim=3)
    dg_p = _cap_scatter(dg_slot, sh.cap_gather, sh.cap_gmask, c, cap_rows)

    def backsub(delta_r):
        return backsub_tags_sparse(v_inv, hct_s, wt_ss, sh.slot_cap, g_t_s,
                                   s_t, sh.tag_active, delta_r.to(dev),
                                   rows=rows)

    return downdate, [wvg_c, wvg_p, dg_c, dg_p], backsub


def schur_solve_sharded_cg(cap_eqs: CapEqs, shards, lam, cam_active,
                           cap_active, reduce_fn,
                           jacobi_scaling: bool = True,
                           min_diag: float = 1e-6, max_diag: float = 1e32,
                           cg_tol: float = 1e-2, cg_iters: int = 100,
                           x0=None):
    """ITERATIVE_SCHUR over tags split into ``shards`` (``CgShard``s):
    the camera/capture side and the CG vectors are replicated on the
    device of ``cap_eqs``, each shard applies its tags' part of the
    implicit Schur complement on its own device, and
    ``reduce_fn(per_shard_lists) -> list`` sums the shards' additive
    values: once at setup, once per matvec.  Returns (d_cam, d_cap,
    [d_tag of each shard], delta_r).  Nothing reads a value back to the
    host."""
    c = cap_eqs.hpp.shape[0]
    dtype, dev = cap_eqs.hcc.dtype, cap_eqs.hcc.device
    s_c, s_p = cap_scale_vectors(cap_eqs, cam_active, cap_active,
                                 jacobi_scaling)
    ops = [_cg_shard_ops(sh, s_c, s_p, lam, c, jacobi_scaling, min_diag,
                         max_diag) for sh in shards]
    hcc, hcp, hpp, g_c, g_p, cam_m, cap_m, m_r = _reduced_blocks(
        cap_eqs, s_c, s_p, cam_active, cap_active, lam, min_diag, max_diag)

    def s_mv(v):
        vm = v * m_r
        vc = vm[:3]
        vp = vm[3:].reshape(c, 6)
        out_c = hcc @ vc + torch.einsum("cij,cj->i", hcp, vp)
        out_p = (torch.einsum("cij,i->cj", hcp, vc)
                 + torch.einsum("cij,cj->ci", hpp, vp))
        (down,) = reduce_fn([[downdate(vm)] for downdate, _, _ in ops])
        av = torch.cat([out_c, out_p.reshape(-1)]) - down
        return av * m_r + (1.0 - m_r) * v

    wvg_c, wvg_p, dg_c, dg_p = reduce_fn([setup for _, setup, _ in ops])
    g_r = torch.cat([g_c, g_p.reshape(-1)])
    rhs = (-g_r + torch.cat([wvg_c, wvg_p.reshape(-1)])) * m_r

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    pc_c = (hcc - dg_c) * cam_m + eye3 * (1.0 - cam_m)
    pc_p = torch.where(cap_m[:, None, None] > 0, hpp - dg_p,
                       torch.eye(6, dtype=dtype, device=dev))
    # inv_ex: the LU inverse without the host read of its error check
    pc_c_inv = torch.linalg.inv_ex(pc_c).inverse
    pc_p_inv = torch.linalg.inv_ex(pc_p).inverse

    def m_inv(v):
        vc = pc_c_inv @ v[:3]
        vp = torch.einsum("cij,cj->ci", pc_p_inv, v[3:].reshape(c, 6))
        return torch.cat([vc, vp.reshape(-1)])

    delta_r = preconditioned_cg(s_mv, rhs, x0, m_inv, cg_tol, cg_iters)
    delta_r = delta_r * m_r
    delta_cam = delta_r[0:3] * s_c
    delta_cap = delta_r[3:].reshape(c, 6) * s_p
    return delta_cam, delta_cap, [backsub(delta_r) for _, _, backsub in ops], \
        delta_r


def schur_solve_grouped_cg(eqs: GroupedEqs, slot_cap, cap_gather, cap_gmask,
                           lam, cam_active, cap_active, tag_active,
                           jacobi_scaling: bool = True,
                           min_diag: float = 1e-6, max_diag: float = 1e32,
                           cg_tol: float = 1e-2, cg_iters: int = 100,
                           x0=None, rows: TagRows | None = None,
                           cap_rows: TagRows | None = None):
    """ITERATIVE_SCHUR: preconditioned CG on the reduced camera system with
    an implicit, capture-sparse Schur complement.  Returns (d_cam, d_cap,
    d_tag, delta_r); ``x0`` warm-starts CG from a previous reduced
    solution.

    Each CG step applies S v = A v - W (V^-1 (W^T v)) against the per-slot
    6x6 blocks: W^T v gathers capture rows by ``slot_cap`` and sums per
    tag, W z routes per-slot products back through the capture-grouped
    permutation.  Memory is O(blocks).  Preconditioner: SCHUR_JACOBI, the
    exact block diagonal of S (damped camera/capture blocks minus the
    per-slot tag corrections), inverted by LU like the reference's
    ``jnp.linalg.inv``: those blocks are a near-cancelling difference and
    can be indefinite, where a Cholesky would distort CG.  The solve is
    ``schur_solve_sharded_cg`` over one shard; nothing in the setup or the
    steps reads a value back to the host.
    """
    shard = CgShard(eqs.hct, eqs.wt_s, eqs.htt, eqs.g_t, slot_cap,
                    cap_gather, cap_gmask, tag_active, rows, cap_rows)
    d_cam, d_cap, (d_tag,), delta_r = schur_solve_sharded_cg(
        CapEqs(eqs.hcc, eqs.hcp, eqs.hpp, eqs.g_c, eqs.g_p), [shard], lam,
        cam_active, cap_active, lambda per_shard: per_shard[0],
        jacobi_scaling=jacobi_scaling, min_diag=min_diag, max_diag=max_diag,
        cg_tol=cg_tol, cg_iters=cg_iters, x0=x0)
    return d_cam, d_cap, d_tag, delta_r
