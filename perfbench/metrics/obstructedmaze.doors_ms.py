"""The program's span ``obstructedmaze.doors`` (``ObstructedMaze_Full``'s
door loop: the unlocked doors, the locked doors with their blocking balls
and their keys in boxes) in host ms a traced step, inclusive, under the
profiler.  A program without the span reads ``None``."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "obstructedmaze.doors")
