"""Descriptor kernel launches a traced step: the program's counter
``levelgen.descs_kernel`` (one count a launch of ``ops/descs.py``'s kernel,
which runs ``LevelGen._rand_objs``' redraw loop on a CUDA tensor) over the
traced steps.  A program whose report has no ``descs.launches`` has no such
kernel, and reads ``None``; one that has it and launched nothing in the
traced steps reads 0."""

from perfbench.harness import program


def read(run):
    rep = program.report()
    counters = rep["counters"] if rep else {}
    if "descs.launches" not in counters or not run.trace_steps:
        return None
    return counters.get("levelgen.descs_kernel", 0) / run.trace_steps
