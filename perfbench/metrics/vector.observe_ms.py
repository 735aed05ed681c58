"""The program's span ``vector.observe`` (``VectorEnv._obs``: ``core/obs.py``
and the ``obs_gather`` launch) in host ms a traced step, inclusive, under
the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "vector.observe")
