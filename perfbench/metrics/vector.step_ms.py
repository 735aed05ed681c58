"""``VectorEnv.step_nofill`` (the transition, the ring's serve, the
observation) in ms a step: the mean of the host-synced spans around it over
the traced run's window."""


def read(run):
    spans = run.spans.get("vector.step_nofill")
    return 1e3 * sum(spans) / len(spans) if spans else None
