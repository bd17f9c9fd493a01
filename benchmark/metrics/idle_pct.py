"""The share of the profiled stretch in which a card ran no kernel and no
copy (the complement of the union of its busy intervals), in %, averaged
over the cards the cell uses."""


def read(run):
    t = run.trace
    if t is None or not t.cards or t.window_s <= 0:
        return None
    idle = [1.0 - t.busy_s(c) / t.window_s for c in t.cards]
    return 100.0 * sum(idle) / len(idle)
