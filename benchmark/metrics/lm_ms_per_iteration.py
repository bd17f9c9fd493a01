"""Host ms of the LM per iteration: the benchmark's span around each
``lm_solve`` call, summed over the window, over every LM iteration the
solves completed (``info["iterations"]``).  The spans leave out the time a
traced run spends stopping its profiler, which the window holds."""


def read(run):
    spans, n = run.spans.get("lm"), run.counters.get("iterations")
    if not spans or not n:
        return None
    return 1e3 * sum(spans) / n
