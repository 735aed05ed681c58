"""The program's span ``fused.step`` (``FusedVectorEnv.step``'s host side, the
kernel's launch included) in host ms a traced step, inclusive, under the
profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "fused.step")
