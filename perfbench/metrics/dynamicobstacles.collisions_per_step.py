"""Collisions a traced step: the program's counter
``dynamicobstacles.collisions`` (the envs whose forward step met anything
but the goal, summed when read) over the traced steps.  A program without
the counter reads ``None``; one that has it and counted no collision in the
traced steps reads 0."""

from perfbench.harness import program


def read(run):
    rep = program.report()
    counters = rep["counters"] if rep else {}
    if "dynamicobstacles.collisions" not in counters or not run.trace_steps:
        return None
    return counters["dynamicobstacles.collisions"] / run.trace_steps
