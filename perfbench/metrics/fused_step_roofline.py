"""``fused_step_kernel``'s share of its roofline, in percent: the least time
the chip could take for the traced calls over the kernel's device time in
the trace.

The least time of one call is the larger of its bytes over HBM bandwidth
and its integer operations over the int32 rate.  Bytes read: each env's
agent row (8 int32) and action; the grid of an env that goes on, only the
front cell of one that finishes; the key and step index once.  Bytes
written: each env's grid, agent row, image (V x V x 3), reward, and the two
end flags; the key and step index.  Operations per env: about 60 for the
step and the action tree, 27 a view cell, 8 V (V - 1) for the occlusion
sweeps; 12 a regenerated cell and 5 threefry hashes per finished env; 3
hashes a step; 80 operations a hash.
"""

from perfbench.harness import peaks

KERNEL = "fused_step_kernel"
AGENT_COLUMNS = 8


def fused_bytes(n: int, w: int, h: int, v: int, done: int) -> int:
    reads = n * (AGENT_COLUMNS * 4 + 4) + (n - done) * w * h * 4 + done * 4 + 16 + 4
    writes = n * (w * h * 4 + AGENT_COLUMNS * 4 + v * v * 3 + 4 + 1 + 1) + 16 + 4
    return reads + writes


def fused_ops(n: int, w: int, h: int, v: int, done: int) -> int:
    hashes = 3 + 5 * done
    return n * (60 + v * v * 27 + 8 * v * (v - 1)) + done * w * h * 12 + hashes * 80


def least_seconds(n: int, w: int, h: int, v: int, done: int) -> float:
    return max(fused_bytes(n, w, h, v, done) / peaks.HBM_BYTES_PER_S,
               fused_ops(n, w, h, v, done) / peaks.INT32_OPS_PER_S)


def read(run):
    if run.trace is None:
        return None
    calls = [t for name, ts in run.trace["kernel_calls"].items() if KERNEL in name
             for t in ts]
    inputs = run.kernel_inputs.get("fused_step", [])
    if not calls or len(calls) != len(inputs):
        return None
    return 100 * sum(least_seconds(*x) for x in inputs) / sum(calls)
