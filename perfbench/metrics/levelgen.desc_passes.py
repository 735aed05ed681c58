"""Descriptor passes a traced step: the program's counter
``levelgen.desc_passes`` (one a pass of ``LevelGen._rand_objs``, the first
draw included; each later pass reads on the host which (env, lane) pairs
are left) over the traced steps.  A program without the counter reads
``None``."""

from perfbench.harness import program


def read(run):
    rep = program.report()
    counters = rep["counters"] if rep else {}
    if "levelgen.desc_passes" not in counters or not run.trace_steps:
        return None
    return counters["levelgen.desc_passes"] / run.trace_steps
