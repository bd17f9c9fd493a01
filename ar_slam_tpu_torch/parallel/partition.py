# Copied from ar_slam_tpu/parallel/partition.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Observation-graph partitioners for the distributed solver.

Two levels:

- ``partition_blocks``: order blocks and deal them into contiguous shards
  (observation sharding only; reductions psum either way, so correctness is
  partition-invariant — tested).
- ``prepare_tag_shards``: partition TAGS (landmarks) over the mesh and
  repack the block table so each shard's slice holds exactly its tags'
  observations.  This makes the per-tag Schur elimination LOCAL to the
  shard that owns the tag — the heavy (Nr, 6) x (6, Nr) per-tag
  contributions reduce into one additive (Nr, Nr) psum instead of
  psum-ing the full (6C, 6T) coupling matrix, and the elimination compute
  splits across devices instead of replicating (see docs/distributed.md).
"""

from __future__ import annotations

import numpy as np


def partition_blocks(cap_idx: np.ndarray, tag_idx: np.ndarray,
                     block_mask: np.ndarray, n_parts: int,
                     by: str = "capture") -> np.ndarray:
    """Return a permutation of block rows placing active blocks in
    locality-preserving contiguous shards (padding rows go last).

    Apply the permutation to every block-axis array before sharding.
    """
    b = cap_idx.shape[0]
    active = np.nonzero(block_mask)[0]
    inactive = np.nonzero(~block_mask)[0]
    if by == "capture":
        key = (cap_idx[active].astype(np.int64) << 32) | tag_idx[active]
    else:
        key = (tag_idx[active].astype(np.int64) << 32) | cap_idx[active]
    order = active[np.argsort(key, kind="stable")]
    perm = np.concatenate([order, inactive])
    assert perm.shape[0] == b
    return perm


def prepare_tag_shards(cap_idx: np.ndarray, tag_idx: np.ndarray,
                       block_mask: np.ndarray, n_tags_padded: int,
                       n_shards: int) -> dict:
    """Partition tags over ``n_shards`` (balanced by observation count) and
    repack the block table into equal per-shard slices of the tags' blocks.

    Tag ids are RENUMBERED so each shard owns a contiguous range of
    ``t_per`` new ids; apply ``tag_perm`` (new-from-old) to every
    tag-indexed array before sharding and ``tag_inv`` to go back.

    Returns a dict with:
      t_per:        tags per shard (t_per * n_shards = t_new)
      tag_perm:     (T_new,) old index for each new tag slot — permute
                    tag-indexed arrays as ``arr_new = arr_old[tag_perm]``
      tag_inv:      (T_old,) new index for each old tag
      row_gather:   (B_new,) old block row feeding each new row (padding
                    rows gather row 0 with mask False)
      row_mask:     (B_new,) False for per-shard padding rows
      row_of_block: (B_old,) new row of each old block row
      new_tag_idx:  (B_new,) renumbered tag id per new row (padding rows
                    point at the owning shard's first tag — safe local
                    gather)
    """
    t_old = n_tags_padded
    t_per = -(-t_old // n_shards)  # ceil; new padded tag count
    t_new = t_per * n_shards

    # observation count per old tag (active blocks only — padding rows are
    # parked on shard of tag 0 and stay masked)
    counts = np.bincount(tag_idx[block_mask], minlength=t_old)

    # LPT greedy: heaviest tags first onto the lightest shard with room
    order = np.argsort(-counts, kind="stable")
    shard_load = np.zeros(n_shards, dtype=np.int64)
    shard_fill = np.zeros(n_shards, dtype=np.int64)
    shard_of_tag = np.empty(t_old, dtype=np.int64)
    for t in order:
        open_shards = np.nonzero(shard_fill < t_per)[0]
        s = open_shards[np.argmin(shard_load[open_shards])]
        shard_of_tag[t] = s
        shard_load[s] += counts[t]
        shard_fill[s] += 1

    # new tag numbering: shard-major, stable within shard
    tag_perm = np.full(t_new, -1, dtype=np.int64)  # new -> old
    tag_inv = np.empty(t_old, dtype=np.int64)  # old -> new
    new_order = np.argsort(shard_of_tag, kind="stable")  # old tags by shard
    fill_ptr = np.zeros(n_shards, dtype=np.int64)
    for t in new_order:
        s = shard_of_tag[t]
        new_id = s * t_per + fill_ptr[s]
        fill_ptr[s] += 1
        tag_inv[t] = new_id
        tag_perm[new_id] = t
    # unfilled new slots (padding tags) gather old tag 0's pose row so the
    # permuted tag arrays stay well-formed; tag_slot_valid marks them so
    # activity masks can force them inactive (put_tag_mask)
    tag_slot_valid = tag_perm >= 0
    tag_perm[tag_perm < 0] = 0

    # block repack: each shard's slice = its tags' block rows, padded.
    # Export-padding rows (block_mask False) can never become active —
    # drop them here instead of inflating tag-0's shard with dead rows
    # every device would linearize each iteration.
    new_tid_of_row = tag_inv[tag_idx]
    shard_of_row = new_tid_of_row // t_per
    per_shard_rows = [
        np.nonzero((shard_of_row == s) & block_mask)[0]
        for s in range(n_shards)
    ]
    b_shard = max(len(rr) for rr in per_shard_rows)
    b_shard = max(b_shard, 1)
    b_new = b_shard * n_shards

    row_gather = np.zeros(b_new, dtype=np.int64)
    row_mask = np.zeros(b_new, dtype=bool)
    new_tag_idx = np.zeros(b_new, dtype=np.int32)
    # dropped (export-padding) rows keep -1: they have no device row
    row_of_block = np.full(tag_idx.shape[0], -1, dtype=np.int64)
    for s, rr in enumerate(per_shard_rows):
        base = s * b_shard
        row_gather[base:base + len(rr)] = rr
        row_mask[base:base + len(rr)] = block_mask[rr]
        new_tag_idx[base:base + len(rr)] = new_tid_of_row[rr]
        # padding rows: point at this shard's first tag (local gather)
        new_tag_idx[base + len(rr):base + b_shard] = s * t_per
        row_of_block[rr] = base + np.arange(len(rr))

    return {
        "t_per": t_per,
        "t_new": t_new,
        "b_shard": b_shard,
        "tag_perm": tag_perm,
        "tag_inv": tag_inv,
        "tag_slot_valid": tag_slot_valid,
        "row_gather": row_gather,
        "row_mask": row_mask,
        "row_of_block": row_of_block,
        "new_tag_idx": new_tag_idx,
    }
