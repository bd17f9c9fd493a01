"""LM iterations per solve (``info["iterations"]``), over the window."""


def read(run):
    n, solves = run.counters.get("iterations"), run.counters.get("solves")
    if not n or not solves:
        return None
    return n / solves
