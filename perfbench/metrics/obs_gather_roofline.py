"""``obs_gather_kernel``'s share of its roofline, in percent: the least time
the chip could take for the traced calls over the kernel's device time in
the trace.

The least time of one call is the larger of its bytes over HBM bandwidth
and its integer operations over the int32 rate.  Bytes: each env's pose
read once (two int32 and the direction), each in-bounds window cell's word
read once, the int32 window written once.  Operations: per view cell the
direction selects (4), two coordinates (6), bounds (4), the address (2) and
the select (1).
"""

import numpy as np

from perfbench.harness import peaks

KERNEL = "obs_gather_kernel"
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])


def in_bounds_cells(pos: np.ndarray, d: np.ndarray, w: int, h: int, v: int) -> int:
    """Window cells inside the grid, over all envs: the agent at view cell
    (v // 2, v - 1) looking up the view."""
    f = DIR_TO_VEC[d]
    r = np.stack([-f[:, 1], f[:, 0]], 1)
    vi = np.arange(v)[None, :, None]
    vj = np.arange(v)[None, None, :]
    wx = pos[:, 0, None, None] + f[:, 0, None, None] * (v - 1 - vj) + r[:, 0, None, None] * (vi - v // 2)
    wy = pos[:, 1, None, None] + f[:, 1, None, None] * (v - 1 - vj) + r[:, 1, None, None] * (vi - v // 2)
    return int(((wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)).sum())


def gather_bytes(pos, d, w: int, h: int, v: int) -> int:
    b = pos.shape[0]
    return b * (2 * 4 + 4) + in_bounds_cells(pos, d, w, h, v) * 4 + b * v * v * 4


def gather_ops(b: int, v: int) -> int:
    return b * v * v * 17


def least_seconds(pos, d, w: int, h: int, v: int) -> float:
    return max(gather_bytes(pos, d, w, h, v) / peaks.HBM_BYTES_PER_S,
               gather_ops(pos.shape[0], v) / peaks.INT32_OPS_PER_S)


def read(run):
    if run.trace is None:
        return None
    calls = [t for name, ts in run.trace["kernel_calls"].items() if KERNEL in name
             for t in ts]
    inputs = run.kernel_inputs.get("obs_gather", [])
    if not calls or len(calls) != len(inputs):
        return None
    return 100 * sum(least_seconds(*x) for x in inputs) / sum(calls)
