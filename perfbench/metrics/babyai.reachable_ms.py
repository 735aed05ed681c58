"""The program's span ``babyai.reachable`` (``BabyAILevel.objs_reachable``:
the reachability flood) in host ms a traced step, inclusive, under the
profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "babyai.reachable")
