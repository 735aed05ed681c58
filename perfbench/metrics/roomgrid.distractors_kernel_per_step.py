"""Distractors kernel launches a traced step: the program's counter
``roomgrid.distractors_kernel`` (one count a launch of
``ops/distractors.py``'s kernel, which places every object of
``RoomGridEnv.add_distractors``' sequential path on a CUDA tensor) over the
traced steps.  A program whose report has no ``distractors.launches`` has no
such kernel, and reads ``None``; one that has it and launched nothing in the
traced steps reads 0."""

from perfbench.harness import program


def read(run):
    rep = program.report()
    counters = rep["counters"] if rep else {}
    if "distractors.launches" not in counters or not run.trace_steps:
        return None
    return counters.get("roomgrid.distractors_kernel", 0) / run.trace_steps
