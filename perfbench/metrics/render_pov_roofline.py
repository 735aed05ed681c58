"""The RGB view render's share of its roofline, in percent: the least time
the chip could take to move the render's bytes over the device time of the
operations launched inside the program's span ``render.pov``, both from
the render pass that ``drivers/vector_rgb.py`` profiles.

Bytes of a call: its frames written (V T x V T x 3 bytes each), the atlas
indices read (V x V int64 a frame) and the atlas read once (every variant
and cell code, T x T x 3 bytes each), at HBM bandwidth.  A program without
the span or the ``render.frames`` counter reads ``None``.
"""

from perfbench.harness import peaks

# the atlas's rows: (plain | highlighted) x (no agent | 4 directions) by
# 34 types x 11 colors x 3 states
ATLAS_ROWS = 10 * 34 * 11 * 3
INDEX_BYTES = 8


def render_bytes(frames: int, calls: int, view: int, tile: int) -> int:
    return (frames * (view * tile) ** 2 * 3 + frames * view * view * INDEX_BYTES
            + calls * ATLAS_ROWS * tile * tile * 3)


def read(run):
    x = run.kernel_inputs.get("render_pov")
    if not x or not x["device_s"]:
        return None
    least = render_bytes(x["frames"], x["calls"], x["view"], x["tile"]) / peaks.HBM_BYTES_PER_S
    return 100 * least / x["device_s"]
