"""Threefry kernel launches a traced step: the program's counter
``rng.threefry`` (one count a launch of ``ops/threefry.py``'s kernel, which
hashes every ``split``, ``bits`` and ``fold_in`` of a CUDA tensor) over the
traced steps.  A program whose report has no ``threefry.launches`` has no
such kernel, and reads ``None``; one that has it and launched nothing in
the traced steps reads 0."""

from perfbench.harness import program


def read(run):
    rep = program.report()
    counters = rep["counters"] if rep else {}
    if "threefry.launches" not in counters or not run.trace_steps:
        return None
    return counters.get("rng.threefry", 0) / run.trace_steps
