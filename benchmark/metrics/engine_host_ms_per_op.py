"""Host ms per operation of the engine's and the solve drivers' own work
between the program's calls, from the program's spans over the profiled
stretch: stacking and padding the photos, unpacking the detections,
adding them to the map store, gathering localize's queries and writing
their poses back, and the solve drivers' calibration, wave planning,
export, the seeds' and the LM's inputs and the write-back (a localize call
passes none of the latter).  No host wait lies inside these spans."""

from benchmark import program_trace as P

SPANS = ("engine.stack", "engine.pad", "engine.unpack", "store.add",
         "localize.gather", "localize.writeback", "solve.calibrate",
         "solve.plan", "solve.export", "solve.seed_inputs",
         "solve.lm_inputs", "solve.writeback")


def read(run):
    s, n = P.summary(), P.ops(run)
    if s is None or not n:
        return None
    return P.host_ms(s, SPANS) / n
