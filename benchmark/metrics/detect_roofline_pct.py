"""The detection stage's least time (benchmark/roofline.py, from the
stage's input and output shapes) over the device time of every kernel that
ran inside the benchmark's detection spans of the profiled stretch, in %."""

from benchmark.roofline import detect_least_ms


def read(run):
    t = run.trace
    ranges = t.spans("detect") if t is not None else []
    shapes = run.counters.get("detect_shapes")
    if not ranges or not shapes:
        return None
    n, h, w = shapes[0]
    least = len(ranges) * detect_least_ms(
        n, h, w, windows=run.counters["windows"],
        candidates=run.cfg["detect"]["candidates"])
    device_ms = sum((e - s) * 1e-3 for r0, r1 in ranges
                    for s, e, _ in t.items(t0=r0, t1=r1, kind="kernel"))
    if device_ms <= 0:
        return None
    return 100.0 * least / device_ms
