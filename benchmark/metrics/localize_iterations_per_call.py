"""LM iterations a localize call runs: the program's counter
``localize.iterations`` (each call's largest iteration count over its
queries, the replays a host-stepped loop would have run) per operation, in
the profiled stretch.  A program without the counter gives None."""

from benchmark import program_trace as P


def read(run):
    s, n = P.summary(), P.ops(run)
    if s is None or not n or "localize.iterations" not in s["counts"]:
        return None
    return s["counts"]["localize.iterations"] / n
