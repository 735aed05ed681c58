"""The program's span ``roomgrid.distractors`` (``RoomGridEnv.add_distractors``:
GoTo's 18 sequential distractor draws) in host ms a traced step, inclusive,
under the profiler."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "roomgrid.distractors")
