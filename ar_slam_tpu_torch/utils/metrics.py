"""Observability: the process's tracer, stage timers and counters, and the
profiler hook (port of ar_slam_tpu/utils/metrics.py).

``TRACE`` (a ``Tracer``) is the port's one record of where its time goes,
process-wide as ``programs.CACHE`` is (the map flow makes a fresh engine
for every map):

- spans: per name a count and the host nanoseconds on one clock,
  ``time.perf_counter_ns`` (CLOCK_MONOTONIC on Linux); while a
  ``torch.profiler`` records, each span is also a profiler range of the
  same name, so a trace's device events can be put down to the innermost
  span around their launch;
- device time of a span that wraps queued work (a program's load and its
  replays): a pair of CUDA events recorded around the work on the current
  stream, resolved at the next host wait or at ``summary()``; no span
  synchronises;
- counters, and the points where the host blocks on the card (``wait``):
  each counts under ``host_wait.<site>`` and is spanned.

It records while a ``torch.profiler`` records, and while ``enabled``
(``--metrics``).  Off, a span site costs a flag check and returns a shared
no-op object.  Storage is bounded: aggregates per name, and a bounded
queue of unresolved event pairs; a lock guards it for ``serve``'s detect
thread.

``Metrics`` keeps an engine's stage timers and counters.  A timer reads
the host clock (each one the engine uses ends in a host read, so its time
holds the device work queued inside it) and is also a span of ``TRACE``.
``profile_trace`` writes a chrome trace of the host and the card
(``torch.profiler``, viewable in Perfetto or chrome://tracing), where the
reference takes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict, deque

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger(__name__)

# event pairs awaiting resolution; beyond this the oldest is dropped (its
# span then shows fewer device_calls than calls)
MAX_PENDING = 4096


class _Off:
    """A span site's object while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "device", "range", "stream", "events",
                 "t0")

    def __init__(self, tracer: "Tracer", name: str, device=None):
        self.tracer, self.name, self.device = tracer, name, device
        self.range = self.stream = self.events = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            # not record_function: its user scope also lays a copy of the
            # range on the card's timeline, which a reader of the device
            # intervals would take for work
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.device is not None and torch.device(
                self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = self.tracer._pair(self.stream.device_index)
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        self.tracer._add(self.name, ns, self.events, None
                         if self.stream is None else self.stream.device_index)
        return False


class Tracer:
    """Spans, their device time, counters and host waits (see the module
    docstring)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._spans: dict = {}  # name -> [calls, host ns, device calls, ms]
        self._counts: dict = {}
        self._pending: deque = deque(maxlen=MAX_PENDING)
        self._free: dict = {}  # card index -> [event pairs]

    @property
    def on(self) -> bool:
        return self.enabled or _profiler._is_profiler_enabled

    def span(self, name: str, device=None):
        """A context manager timing the enclosed host work under ``name``;
        with ``device`` a card, also the device time of the work enqueued
        on its current stream meanwhile."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name, device)

    def count(self, name: str, n=1) -> None:
        if self.enabled or _profiler._is_profiler_enabled:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def wait(self, site: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, a call in which the host blocks on the
        card (a read of a card's tensor, a blocking copy to it): counted and
        spanned as ``host_wait.<site>``; then the event pairs the card has
        passed are resolved."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return fn(*args, **kwargs)
        name = "host_wait." + site
        with _Span(self, name):
            out = fn(*args, **kwargs)
        self.count(name)
        self._resolve(block=False)
        return out

    def _pair(self, card: int) -> tuple:
        with self._lock:
            free = self._free.get(card)
            if free:
                return free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _add(self, name: str, ns: int, events, card) -> None:
        with self._lock:
            rec = self._spans.get(name)
            if rec is None:
                rec = self._spans[name] = [0, 0, 0, 0.0]
            rec[0] += 1
            rec[1] += ns
            if events is not None:
                self._pending.append((rec, events, card))

    def _resolve(self, block: bool) -> None:
        """Add the device ms of the pending event pairs, in order, up to the
        first the card has not passed (``block``: every one, waiting)."""
        with self._lock:
            while self._pending:
                rec, (start, end), card = self._pending[0]
                if block:
                    end.synchronize()
                elif not end.query():
                    break
                self._pending.popleft()
                rec[2] += 1
                rec[3] += start.elapsed_time(end)
                self._free.setdefault(card, []).append((start, end))

    def summary(self) -> dict:
        """{"spans": {name: {"calls", "host_ms"} and, for spans with device
        time, "device_calls", "device_ms"}, "counts": {name: n}}.  Waits for
        the pending event pairs: call it off the hot path."""
        self._resolve(block=True)
        with self._lock:
            spans = {}
            for name, (calls, ns, dev_calls, dev_ms) in sorted(
                    self._spans.items()):
                spans[name] = {"calls": calls, "host_ms": ns * 1e-6}
                if dev_calls:
                    spans[name].update(device_calls=dev_calls,
                                       device_ms=dev_ms)
            return {"spans": spans, "counts": dict(sorted(
                self._counts.items()))}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self._pending.clear()


TRACE = Tracer()


class Metrics:
    """Accumulating counters + stage timings (host seconds)."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.timings: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            with TRACE.span(name):
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
    ``log_dir``; no-op when log_dir is falsy or a profiler already records
    (the outer one holds the work)."""
    if not log_dir or _profiler._is_profiler_enabled:
        yield
        return
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
