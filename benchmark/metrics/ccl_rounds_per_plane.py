"""Rounds a connected-components plane of K2 ran: the program's counter
``detect.k2.rounds`` over ``detect.k2.planes`` (the planes of the calls'
photos, padding frames left out), in the profiled stretch.  A program
without the counters, or a stretch with no K2 plane, reads None."""

from benchmark import program_trace as P


def read(run):
    s = P.summary()
    planes = s["counts"].get("detect.k2.planes") if s else None
    if not planes:
        return None
    return s["counts"].get("detect.k2.rounds", 0) / planes
