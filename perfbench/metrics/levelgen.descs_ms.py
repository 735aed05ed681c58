"""The program's span ``levelgen.descs`` (``LevelGen._rand_objs``: the
descriptor draws, a host read of the pairs left after each pass) in host ms
a traced step, inclusive, under the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "levelgen.descs")
