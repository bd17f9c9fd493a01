"""Runtime calls that enqueue work on the card (kernel launches, graph
launches, copies, fills) per operation, in the profiled stretch."""


def read(run):
    t = run.trace
    ops = t.spans("op") if t is not None else []
    if not ops:
        return None
    return sum(t.launches_in(s, e) for s, e in ops) / len(ops)
