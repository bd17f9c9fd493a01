"""Observability: stage timers, metrics counters, profiler hook (port of
ar_slam_tpu/utils/metrics.py).

Structured per-stage wall timings and engine counters, and a
``torch.profiler`` trace of the host and the card around device work
(a chrome trace, viewable in Perfetto or chrome://tracing), where the
reference takes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

logger = logging.getLogger(__name__)


class Metrics:
    """Accumulating counters + stage timings."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.timings: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = dict(self.counters)
        for name, vals in self.timings.items():
            out[f"{name}_s"] = round(sum(vals), 4)
            out[f"{name}_calls"] = len(vals)
        return out


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the enclosed work with ``torch.profiler`` (CPU and, where a
    card is present, CUDA activities) and write a chrome trace into
    ``log_dir``; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)
