"""The program's own tracer as the per-layer readers see it.

``ar_slam_tpu_torch.utils.metrics.TRACE`` records while a
``torch.profiler`` records, so in a traced run its records cover the
profiled stretch and nothing else.  A program without the tracer, or a run
in which it recorded nothing, gives no summary, and the readers then
return None.
"""

from __future__ import annotations


def summary():
    """The tracer's summary ({"spans", "counts"}), or None."""
    try:
        from ar_slam_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    s = TRACE.summary()
    return s if s["spans"] or s["counts"] else None


def ops(run) -> int:
    """The operations of the profiled stretch."""
    return len(run.trace.spans("op")) if run.trace is not None else 0


def host_ms(s: dict, names) -> float:
    return sum(s["spans"].get(n, {}).get("host_ms", 0.0) for n in names)


def device_ms(s: dict, names):
    """The event-timed device ms of the spans ``names``; None where none
    of them holds device time (the CPU)."""
    got = [s["spans"][n]["device_ms"] for n in names
           if "device_ms" in s["spans"].get(n, {})]
    return sum(got) if got else None
