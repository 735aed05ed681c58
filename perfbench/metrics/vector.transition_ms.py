"""The program's span ``vector.transition`` (``VectorEnv._step_envs``:
``core/step.py`` and the family's ``post_step``) in host ms a traced step,
inclusive, under the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "vector.transition")
