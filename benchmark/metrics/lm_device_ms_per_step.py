"""Device ms of the LM per step: the event-timed device ms of the LM
program's ``step``, ``accept`` and ``reject`` runs (the program's spans
``program.lm.step`` / ``.accept`` / ``.reject``) over its counter
``lm.steps``, in the profiled stretch.  A program without the counter, or
a run with no device time (the CPU), gives None."""

from benchmark import program_trace as P

SPANS = ("program.lm.step", "program.lm.accept", "program.lm.reject")


def read(run):
    s = P.summary()
    steps = s["counts"].get("lm.steps") if s else None
    if not steps:
        return None
    ms = P.device_ms(s, SPANS)
    return None if ms is None else ms / steps
