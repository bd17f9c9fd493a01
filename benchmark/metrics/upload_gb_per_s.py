"""GB/s of the detector's upload: the bytes its loads copy in from the
host (the program's counter ``program.detect.bytes_h2d``) over the host
seconds of its loads (the span ``program.detect.load``, which holds the
pageable copy and its staging), in the profiled stretch; on a card only
(the CPU copies nothing)."""

from benchmark import program_trace as P


def read(run):
    s = P.summary()
    load = s["spans"].get("program.detect.load", {}) if s else {}
    if "device_ms" not in load or not load["host_ms"]:
        return None
    return s["counts"].get("program.detect.bytes_h2d", 0) / (
        load["host_ms"] * 1e-3) / 1e9
