"""``VectorEnv.refill`` (the generator filling the ring's windows) in ms a
step: the host-synced spans around it over the traced run's window, divided
by the steps the refills served."""


def read(run):
    refills = run.spans.get("vector.refill")
    steps = run.spans.get("vector.step_nofill")
    return 1e3 * sum(refills) / len(steps) if refills and steps else None
