"""The program's span ``dynamicobstacles.moves`` (``DynamicObstaclesEnv``'s
step: the stream split and the loop that moves each ball in turn) in host ms
a traced step, inclusive, under the profiler.  A program without the span
reads ``None``."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "dynamicobstacles.moves")
