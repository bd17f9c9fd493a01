"""Host ms of the solve drivers per map: the benchmark's span around each
``ArSlamEngine.solve`` call."""


def read(run):
    spans = run.spans.get("solve")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
