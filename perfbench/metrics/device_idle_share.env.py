"""The share of the traced window in which no operation ran on the device:
1 - (union of kernel, copy and memset intervals) / (window's host-clock
length)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 1 - run.trace["busy_s"] / run.trace["window_s"]
