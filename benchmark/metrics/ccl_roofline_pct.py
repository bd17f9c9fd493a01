"""The connected-components role's least time (benchmark/roofline.py,
from the detection stage's shapes) over the device time of the
connected-components kernels that ran inside the benchmark's detection
spans of the profiled stretch, in %: K2 (``ccl_fused``) and K3
(``strip_init``, ``strip_row``, ``strip_col``), found by the names the
profiler prints."""

import re

from benchmark.roofline import detect_roles

KERNELS = re.compile(r"ccl_fused|strip_(?:init|row|col)")


def read(run):
    t = run.trace
    ranges = t.spans("detect") if t is not None else []
    shapes = run.counters.get("detect_shapes")
    if not ranges or not shapes:
        return None
    n, h, w = shapes[0]
    least = len(ranges) * detect_roles(
        n, h, w, windows=run.counters["windows"],
        candidates=run.cfg["detect"]["candidates"])["components"]
    device_ms = sum((e - s) * 1e-3 for r0, r1 in ranges
                    for s, e, name in t.items(t0=r0, t1=r1, kind="kernel")
                    if KERNELS.search(name))
    if device_ms <= 0:
        return None
    return 100.0 * least / device_ms
