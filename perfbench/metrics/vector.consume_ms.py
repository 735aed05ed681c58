"""The program's span ``vector.consume`` (``VectorEnv._consume``: the ring's
serve) in host ms a traced step, inclusive, under the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "vector.consume")
