"""8-connected component labels: K2 and K3 (port of detect/pallas_ccl.py).

Label = the component's minimum linear index in the true width; background
= 2^30.  Both kernels keep the reference's round and its ``iters`` cap, so
they equal the reference label for label also where the cap cuts a
component short.  Each wrapper launches its CUDA kernel on a CUDA tensor
and runs its plain version on a CPU tensor.

- ``connected_components_batch`` (K2, ``csrc/ccl.cu``) replaces
  ``_ccl_fused_kernel`` (via ``connected_components_fused_batch``), which
  the reference runs on planes up to ``FUSED_CCL_PIXEL_LIMIT``.  Its round
  is Gauss-Seidel: 64-row strips are updated in place, in order, and
  dirty-strip and dirty-column-group flags choose which strips and 128-wide
  column groups run (``connected_components_fused_plain`` transcribes it).
  One launch runs the whole batch, each plane on a thread-block cluster
  that stops on the card at its fixpoint or at the cap; the rounds each
  plane ran stay on the card until ``fused_plane_rounds`` asks for them
  (on the CPU the plain version keeps its rounds in the same place).
  Traced, ``trace_fused_rounds`` adds a call's planes and their rounds to
  the tracer's counters ``detect.k2.planes`` and ``detect.k2.rounds``.
- ``connected_components_strip_batch`` (K3, ``csrc/ccl_strip.cu``) replaces
  the strip kernels ``_row_kernel`` / ``_col_kernel`` (via
  ``connected_components_pallas_batch``), run above that limit.  Its round
  is Jacobi (``connected_components_plain``).  One call enqueues all
  ``iters`` rounds (1 + 2 x iters kernels) and reads nothing back: each
  plane stops on the card after its first round that changed nothing,
  which gives the labels of the reference's batch-global exit, since a
  converged plane stays fixed.  The rounds each plane ran stay on the card
  until ``strip_plane_rounds`` asks for them.

The launch counts count the kernels a replay of a captured detector runs
too (programs.py adds what the capture recorded).

A round is a 3x3 min-pool of the foreground, then the min over every full
foreground run along rows, then along columns.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch import cuda
from ar_slam_tpu_torch.utils.metrics import TRACE

BIG = 2**30
GROUP = 128  # K2's column-group width (the reference's ``cstrip``)
launches = 0  # K2 launches since the last reset (CUDA path only)
fused_round_reads = 0  # host reads of K2's per-plane rounds
_fused_rounds = None  # (N,) int32 rounds each plane ran in the last K2 launch
# (or replay of a captured detector: detect/detect.py POINTERS; or call of
# the plain version on the CPU)
strip_launches = 0  # K3 launches since the last reset (CUDA path only)
strip_kernel_launches = 0  # the CUDA kernels they enqueued (1 + 2 x iters)
strip_flag_reads = 0  # host reads of K3's round flags (strip_plane_rounds)
_strip_flags = None  # (iters, N) int32 of the last K3 launch (or replay), on
# the card: 1 where round r changed plane p


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


def fused_geometry(h: int, w: int) -> tuple[int, int, int]:
    """The reference fused kernel's padding (pallas_ccl.py:366-377): the
    strip height, the number of strips and of 128-wide column groups.
    Pad rows and columns are background; the flags depend on this
    geometry."""
    if h > 64:
        strip = 64
        h_pad = -(-h // 64) * 64
    else:
        h_pad = -(-h // 8) * 8
        strip = h_pad
    return strip, h_pad // strip, -(-w // GROUP)


def fused_plane_plain(plane: torch.Tensor, iters: int = 24
                      ) -> tuple[torch.Tensor, int]:
    """One (H, W) bool plane through the reference's ``_ccl_fused_kernel``
    (pallas_ccl.py:197-352), transcribed in its sequential order: labels
    and the rounds run.  Strips are updated in place, so a strip's first
    row pools the final row above it when the strip above ran."""
    h, w = plane.shape
    strip, n_rs, n_cs = fused_geometry(h, w)
    dev = plane.device
    idx = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    a = torch.full((n_rs * strip, n_cs * GROUP), BIG, dtype=torch.int32,
                   device=dev)
    a[:h, :w] = torch.where(plane, idx, big)
    big_row = a.new_full((1, a.shape[1]), BIG)
    drow, dcol = [True] * n_rs, [False] * n_cs
    rounds, changed = 0, True
    while rounds < iters and changed:
        dnext, changed = [False] * n_rs, False

        def mark_dirty(s):
            nonlocal changed
            for i in range(max(s - 1, 0), min(s + 1, n_rs - 1) + 1):
                dnext[i] = True
            changed = True

        for s in range(n_rs):  # row stage, in place over dirty strips
            if not drow[s]:
                continue
            r0 = s * strip
            mid = a[r0:r0 + strip]
            tile = torch.cat([a[r0 - 1:r0] if s else big_row, mid,
                              a[r0 + strip:r0 + strip + 1]
                              if s + 1 < n_rs else big_row])
            m = torch.minimum(torch.minimum(tile[:-2], tile[1:-1]), tile[2:])
            m = torch.minimum(m, torch.minimum(_shift(m, 1, 1, BIG),
                                               _shift(m, -1, 1, BIG)))
            lab = _run_min_scan(torch.where(mid < BIG, m, big), 1)
            groups = (lab != mid).reshape(strip, n_cs, GROUP).any(2).any(0)
            if bool(groups.any()):
                mark_dirty(s)
                dcol = [d or g for d, g in zip(dcol, groups.tolist())]
            a[r0:r0 + strip] = lab
        for c in range(n_cs):  # column stage over flagged groups
            if dcol[c]:
                tile = a[:, c * GROUP:(c + 1) * GROUP]
                out = _run_min_scan(tile, 0)
                bands = (out != tile).reshape(n_rs, strip * GROUP).any(1)
                a[:, c * GROUP:(c + 1) * GROUP] = out
                for b in torch.nonzero(bands).flatten().tolist():
                    mark_dirty(b)
            dcol[c] = False
        drow = dnext
        rounds += 1
    return a[:h, :w].clone(), rounds


def _fused_plain(binary: torch.Tensor, iters: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``connected_components_fused_plain``'s labels and the (N,) int32
    rounds each plane ran."""
    runs = [fused_plane_plain(p, iters) for p in binary]
    labels = (torch.stack([lab for lab, _ in runs]) if runs else
              torch.empty(binary.shape, dtype=torch.int32,
                          device=binary.device))
    return labels, torch.tensor([r for _, r in runs], dtype=torch.int32,
                                device=binary.device)


def connected_components_fused_plain(binary: torch.Tensor,
                                     iters: int = 24) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 labels of the reference's fused
    kernel under its cap, plain PyTorch, plane by plane."""
    return _fused_plain(binary, iters)[0]


def connected_components_batch(binary: torch.Tensor,
                               iters: int = 24) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 labels after at most ``iters``
    Gauss-Seidel rounds (K2; the reference's
    ``connected_components_fused_batch``)."""
    global launches, _fused_rounds
    if binary.device.type == "cpu":
        labels, _fused_rounds = _fused_plain(binary, iters)
        return labels
    cuda.require(binary, "binary", torch.bool, 3)
    n, h, w = binary.shape
    strip = fused_geometry(h, w)[0]
    labels = torch.empty((n, h, w), dtype=torch.int32, device=binary.device)
    scratch = torch.empty_like(labels)
    rounds = torch.empty((n,), dtype=torch.int32, device=binary.device)
    cuda.check(cuda.library().arslam_ccl(
        binary.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
        rounds.data_ptr(), n, h, w, strip, iters, cuda.stream()),
        "arslam_ccl")
    launches += 1
    _fused_rounds = rounds
    return labels


def fused_resident_planes(h: int, w: int) -> int:
    """How many (h, w) planes K2 keeps on the card at once (one cluster
    each); a batch larger than this runs in waves."""
    strip = fused_geometry(h, w)[0]
    n = cuda.library().arslam_ccl_resident_planes(h, w, strip)
    if n < 0:
        raise RuntimeError(f"arslam_ccl_resident_planes failed with {-n}")
    return n


def fused_plane_rounds() -> list[int]:
    """The rounds each plane of the last K2 launch ran (at most its cap).
    Reads the card; counted in ``fused_round_reads``."""
    global fused_round_reads
    if _fused_rounds is None:
        raise RuntimeError("no K2 launch yet")
    fused_round_reads += 1
    return _fused_rounds.tolist()


def trace_fused_rounds(frames: int, batch: int) -> None:
    """Add the planes of the first ``frames`` frames of the last K2
    launch's ``batch`` (the rest are padding; planes are window-major) to
    the tracer's counter ``detect.k2.planes``, and the rounds they ran to
    ``detect.k2.rounds``: one read of the rounds, the host wait
    ``detect.k2_rounds`` (not counted in ``fused_round_reads``).  For the
    caller to make only while ``TRACE`` records, after the launch's
    outputs are read."""
    rounds = TRACE.wait("detect.k2_rounds", _fused_rounds.cpu)
    real = rounds.reshape(-1, batch)[:, :frames]
    TRACE.count("detect.k2.planes", real.numel())
    TRACE.count("detect.k2.rounds", int(real.sum()))


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
