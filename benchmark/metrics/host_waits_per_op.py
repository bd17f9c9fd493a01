"""Points per operation at which the host blocked on the card: every
``host_wait.<site>`` counter of the program's tracer (reads of a card's
tensor, blocking copies to it), in the profiled stretch."""

from benchmark import program_trace as P


def read(run):
    s, n = P.summary(), P.ops(run)
    if s is None or not n:
        return None
    return sum(v for k, v in s["counts"].items()
               if k.startswith("host_wait.")) / n
