"""Host ms of the detection layer per photo: the benchmark's span around
each ``ArSlamEngine._run_detector`` call (ending with its outputs on the
host), summed over the window, over the photos detected."""


def read(run):
    spans = run.spans.get("detect")
    photos = run.counters.get("photos")
    if not spans or not photos:
        return None
    return 1e3 * sum(spans) / photos
