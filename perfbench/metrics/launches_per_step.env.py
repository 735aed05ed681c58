"""Kernel launches the host issued a step: the ``cudaLaunchKernel`` family
in the profiler's trace of the program's calls alone, over the traced
steps."""


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    return run.trace["launches"] / run.trace_steps
