"""8-connected component labels: K2 and K3 (port of detect/pallas_ccl.py).

Label = the component's minimum linear index in the true width; background
= 2^30.  Each wrapper launches its CUDA kernel on a CUDA tensor and runs
``connected_components_plain`` on a CPU tensor.

- ``connected_components_batch`` (K2, ``csrc/ccl.cu``) replaces
  ``_ccl_fused_kernel`` (via ``connected_components_fused_batch``), which
  the reference runs on planes up to ``FUSED_CCL_PIXEL_LIMIT``.  It is
  union-find and always resolves fully, where the reference stops after
  ``ccl_iters`` rounds (a deliberate divergence only on shapes needing more
  rounds); its plain version iterates to the fixpoint with no cap.
- ``connected_components_strip_batch`` (K3, ``csrc/ccl_strip.cu``) replaces
  the strip kernels ``_row_kernel`` / ``_col_kernel`` (via
  ``connected_components_pallas_batch``), run above that limit.  It keeps
  the reference's round and its ``iters`` cap, so it equals the reference
  exactly also where the cap cuts a component short.  One call enqueues
  all ``iters`` rounds (1 + 2 x iters kernels) and reads nothing back: each
  plane stops on the card after its first round that changed nothing,
  which gives the labels of the reference's batch-global exit, since a
  converged plane stays fixed.  The rounds each plane ran stay on the card
  until ``strip_plane_rounds`` asks for them.

The plain version runs the reference's round (3x3 min-pool, then the min
over every full foreground run along rows, then along columns, each stage
reading the whole previous stage) until nothing changes or ``iters``
rounds have run.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch import cuda

BIG = 2**30
launches = 0  # K2 launches since the last reset (CUDA path only)
strip_launches = 0  # K3 launches since the last reset (CUDA path only)
strip_kernel_launches = 0  # the CUDA kernels they enqueued (1 + 2 x iters)
strip_flag_reads = 0  # host reads of K3's round flags (strip_plane_rounds)
_strip_flags = None  # (iters, N) int32 of the last K3 launch, on the card:
# 1 where round r changed plane p


def _shift(x: torch.Tensor, delta: int, dim: int, fill) -> torch.Tensor:
    """Shift ``x`` by +delta along ``dim`` (values move to higher indices),
    filling the vacated cells."""
    size = x.shape[dim]
    if abs(delta) >= size:
        return torch.full_like(x, fill)
    pad_shape = list(x.shape)
    pad_shape[dim] = abs(delta)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if delta > 0:
        return torch.cat([pad, x.narrow(dim, 0, size - delta)], dim=dim)
    return torch.cat([x.narrow(dim, -delta, size + delta), pad], dim=dim)


def _run_min_scan(labels: torch.Tensor, dim: int) -> torch.Tensor:
    """Min over each full foreground run along ``dim``; foreground = label <
    BIG.  Each run gets its own number (a running count of run starts, which
    restarts no run across lines since a line's first foreground pixel always
    starts one), then one scatter-min per run and a gather back."""
    x = labels.movedim(dim, -1)
    fg = x < BIG
    start = fg.clone()
    start[..., 1:] &= ~fg[..., :-1]
    run = torch.cumsum(start.reshape(-1), 0)
    mins = torch.full((x.numel() + 1,), BIG, dtype=labels.dtype,
                      device=labels.device)
    mins.scatter_reduce_(0, run, x.reshape(-1), "amin")
    return torch.where(fg, mins[run].reshape(x.shape), x).movedim(-1, dim)


def _min_pool3(labels: torch.Tensor) -> torch.Tensor:
    m = torch.minimum(labels, torch.minimum(_shift(labels, 1, 1, BIG),
                                            _shift(labels, -1, 1, BIG)))
    return torch.minimum(m, torch.minimum(_shift(m, 1, 2, BIG),
                                          _shift(m, -1, 2, BIG)))


def connected_components_plain(binary: torch.Tensor,
                               iters: int | None = None) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 labels, plain PyTorch: rounds
    until nothing changes, at most ``iters`` (None: no cap)."""
    n, h, w = binary.shape
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=binary.device).reshape(1, h, w)
    big = torch.tensor(BIG, dtype=torch.int32, device=binary.device)
    labels = torch.where(binary, idx, big)
    rounds = 0
    while iters is None or rounds < iters:
        rounds += 1
        new = torch.where(binary, torch.minimum(labels, _min_pool3(labels)),
                          big)
        new = _run_min_scan(_run_min_scan(new, 2), 1)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def connected_components_batch(binary: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 component labels."""
    global launches
    if binary.device.type == "cpu":
        return connected_components_plain(binary)
    cuda.require(binary, "binary", torch.bool, 3)
    n, h, w = binary.shape
    labels = torch.empty((n, h, w), dtype=torch.int32, device=binary.device)
    cuda.check(cuda.library().arslam_ccl(binary.data_ptr(), labels.data_ptr(),
                                         n, h, w, cuda.stream()),
               "arslam_ccl")
    launches += 1
    return labels


def connected_components_strip_batch(binary: torch.Tensor,
                                     iters: int = 24) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 labels after at most ``iters``
    rounds (K3; the reference's ``connected_components_pallas_batch``)."""
    global strip_launches, strip_kernel_launches, _strip_flags
    if binary.device.type == "cpu":
        return connected_components_plain(binary, iters)
    cuda.require(binary, "binary", torch.bool, 3)
    n, h, w = binary.shape
    labels = torch.empty((n, h, w), dtype=torch.int32, device=binary.device)
    scratch = torch.empty_like(labels)
    flags = torch.empty((iters, n), dtype=torch.int32, device=binary.device)
    cuda.check(cuda.library().arslam_ccl_strip(
        binary.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
        flags.data_ptr(), n, h, w, iters, cuda.stream()), "arslam_ccl_strip")
    strip_launches += 1
    strip_kernel_launches += 1 + 2 * iters
    _strip_flags = flags
    return labels


def strip_plane_rounds() -> tuple[list[int], list[bool]]:
    """The rounds each plane of the last K3 launch ran, and whether it
    reached its fixpoint (a round that changed nothing) within the cap.
    Reads the card; counted in ``strip_flag_reads``."""
    global strip_flag_reads
    if _strip_flags is None:
        raise RuntimeError("no K3 launch on a CUDA tensor yet")
    strip_flag_reads += 1
    iters = _strip_flags.shape[0]
    changing = _strip_flags.sum(dim=0).cpu()
    return (torch.clamp(changing + 1, max=iters).tolist(),
            (changing < iters).tolist())


def strip_rounds() -> int:
    """The most rounds any plane of the last K3 launch ran."""
    return max(strip_plane_rounds()[0], default=0)
