"""The useful share of the ring's auto-resets over the window: the program's
``n_fresh / (n_fresh + n_stale)`` counters, read before and after it."""


def read(run):
    served = run.counters.get("n_fresh", 0) + run.counters.get("n_stale", 0)
    return run.counters["n_fresh"] / served if served else None
