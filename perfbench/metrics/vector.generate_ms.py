"""The program's span ``vector.generate`` (the generator call of
``VectorEnv._refill_windows``; in the traced steps only the refills call
it) in host ms a traced step, inclusive, under the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "vector.generate")
