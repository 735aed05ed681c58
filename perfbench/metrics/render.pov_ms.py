"""The program's span ``render.pov`` (``ops/render.py::pov_render_batch``:
the view's atlas indices, the gather and the frame layout) in host ms a
traced step, inclusive, under the profiler.  A program without the span
reads ``None``."""

from perfbench.harness.program import span_ms


def read(run):
    return span_ms(run, "render.pov")
