"""Device ms of the host-to-device copies inside the benchmark's detection
spans of the profiled stretch, per photo detected there."""


def read(run):
    t = run.trace
    ranges = t.spans("detect") if t is not None else []
    shapes = run.counters.get("detect_shapes")
    if not ranges or not shapes or not run.counters.get("calls"):
        return None
    photos = len(ranges) * run.counters["photos"] / run.counters["calls"]
    ms = sum((e - s) * 1e-3 for r0, r1 in ranges
             for s, e, _ in t.items(t0=r0, t1=r1, kind="h2d"))
    return ms / photos
