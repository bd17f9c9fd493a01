"""Spans of the benchmark's own, and the summary of a profiled stretch.

``Spans`` times the calls the benchmark makes into the program's layers on
the host clock; while a stretch is profiled each span is also a
``record_function`` range named ``bench.<name>``, so the profiler's device
events can be assigned to it.  ``Profile`` keeps, from ``torch.profiler``'s
events, only what the per-layer metrics read: device intervals (kernels,
copies, fills) per card, the runtime calls that enqueue work, and the
benchmark's ranges.  No trace file is written.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

# the runtime calls that enqueue work on a card (a graph replay is one
# cudaGraphLaunch), as torch.profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
               "cudaGraphLaunch")
PREFIX = "bench."


class Spans:
    """Host-clock durations (s) of named calls, and their count."""

    def __init__(self):
        self.seconds = defaultdict(list)
        self.recording = False

    @contextmanager
    def __call__(self, name: str):
        if self.recording:
            from torch.profiler import record_function

            ctx = record_function(PREFIX + name)
        else:
            ctx = _nothing()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """``fn`` inside a span named ``name``."""
        def spanned(*a, **k):
            with self(name):
                return fn(*a, **k)
        return spanned


@contextmanager
def _nothing():
    yield


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, t0: float, t1: float) -> list:
    """(start, end) of the stretches of [t0, t1] no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


class Profile:
    """What a profiled stretch left: times in microseconds on the
    profiler's clock."""

    def __init__(self, prof, cards: list):
        from torch.autograd import DeviceType

        self.cards = cards
        self.device = defaultdict(list)  # card -> [(start, end, name)]
        self.launches = []  # (start, name)
        self.ranges = []  # (start, end, span name)
        for e in prof.events():
            t = e.time_range
            if e.name.startswith(PREFIX):
                # the benchmark's ranges on the host; their copies on the
                # device's timeline are annotations, not work
                if e.device_type == DeviceType.CPU:
                    self.ranges.append((t.start, t.end, e.name[len(PREFIX):]))
            elif e.device_type == DeviceType.CUDA:
                self.device[e.device_index].append((t.start, t.end, e.name))
            elif e.name in LAUNCH_APIS:
                self.launches.append((t.start, e.name))
        stretch = [r for r in self.ranges if r[2] == "stretch"]
        if stretch:
            self.t0, self.t1, _ = max(stretch, key=lambda r: r[1] - r[0])
        else:
            self.t0 = min((r[0] for r in self.ranges), default=0.0)
            self.t1 = max((r[1] for r in self.ranges), default=0.0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def spans(self, name: str) -> list:
        return [(s, e) for s, e, n in self.ranges if n == name]

    def items(self, card=None, t0=None, t1=None, kind=None) -> list:
        """Device items (start, end, name) starting inside [t0, t1] on
        ``card`` (default: every card); ``kind`` "kernel" leaves out the
        copies and fills, "h2d" keeps host-to-device copies alone."""
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        cards = self.device if card is None else {card: self.device[card]}
        out = []
        for items in cards.values():
            for s, e, n in items:
                if not t0 <= s <= t1:
                    continue
                copy = n.startswith("Memcpy") or n.startswith("Memset")
                if kind == "kernel" and copy:
                    continue
                if kind == "h2d" and "HtoD" not in n:
                    continue
                out.append((s, e, n))
        return out

    def busy_s(self, card) -> float:
        """Seconds of the stretch in which ``card`` ran a kernel or a
        copy: the union of its intervals, clipped to the stretch."""
        iv = [(max(s, self.t0), min(e, self.t1))
              for s, e, _ in self.device.get(card, [])
              if e > self.t0 and s < self.t1]
        return union_length(iv) * 1e-6

    def launches_in(self, t0: float, t1: float) -> int:
        return sum(1 for s, _ in self.launches if t0 <= s <= t1)

    def breakdown(self) -> dict:
        """The 10 device operations that took most time in the stretch,
        and the 10 longest idle gaps of the home card named by the
        innermost benchmark span around them."""
        by_name = defaultdict(float)
        for s, e, n in self.items():
            by_name[n] += (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        home = self.cards[0] if self.cards else 0
        iv = [(s, e) for s, e, _ in self.device.get(home, [])]
        idle = []
        for s, e in gaps(iv, self.t0, self.t1):
            mid = 0.5 * (s + e)
            around = [r for r in self.ranges
                      if r[0] <= mid <= r[1] and r[2] != "stretch"]
            name = (min(around, key=lambda r: r[1] - r[0])[2] if around
                    else "between calls")
            idle.append([name, (e - s) * 1e-6])
        idle.sort(key=lambda x: -x[1])
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": idle[:10]}
