"""Device ms of the detector's replays (the program's span
``program.detect.detect``: the card's time from a CUDA event recorded
before each replay to one after it) over the photos detected (the
program's counter ``detect.photos``, before the batch's padding), in the
profiled stretch.  One replay a batch, so the launch's own time under the
profiler is a small part of it."""

from benchmark import program_trace as P


def read(run):
    s = P.summary()
    if s is None or not s["counts"].get("detect.photos"):
        return None
    ms = P.device_ms(s, ("program.detect.detect",))
    return None if ms is None else ms / s["counts"]["detect.photos"]
