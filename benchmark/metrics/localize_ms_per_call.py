"""Host ms of the localize layer per call: the benchmark's span around
each ``localize_many`` call (ending with the poses on the host)."""


def read(run):
    spans = run.spans.get("localize")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
