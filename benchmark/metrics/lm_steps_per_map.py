"""LM steps per map: the program's counter ``lm.steps`` (one per ``step``
stage the host loop ``lm_iterate`` runs, on the card a replay) over the
operations of the profiled stretch.  A program without the counter gives
None."""

from benchmark import program_trace as P


def read(run):
    s, n = P.summary(), P.ops(run)
    if s is None or not n or "lm.steps" not in s["counts"]:
        return None
    return s["counts"]["lm.steps"] / n
