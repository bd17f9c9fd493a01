"""Program captures (CUDA graph recordings, ``programs.CACHE.captures``)
per operation over the window: a program whose signature differs from the
one its cache holds is recorded anew inside the call."""


def read(run):
    calls = run.counters.get("calls")
    if not calls or "captures" not in run.counters:
        return None
    return run.counters["captures"] / calls
