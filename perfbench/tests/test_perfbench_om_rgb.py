"""CPU tests of the cells ``obstructedmaze-full.pooled-random`` and
``doorkey-8x8.rgb-partial``: a tiny run of each cell is ``correct``; the
two controls make it false (a frame whose invisible cells are drawn,
through ``obs_wrong``; levels whose box contents are dropped, through
``start_wrong`` at the reset and ``ring_wrong`` at each refill); the
cells' readers read ``None`` without the program's spans, and their values
with them; and the span's device time is taken from the launches inside
it.

    python -m pytest perfbench/tests/test_perfbench_om_rgb.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program, span_device  # noqa: E402

OM = "obstructedmaze-full.pooled-random"
RGB = "doorkey-8x8.rgb-partial"
SEED = 2**40 + 12345
# per cell: a batch the CPU runs in seconds, and episodes cut so that
# auto-resets happen inside a short run
TINY = {
    OM: ({"num_envs": 64, "warmup_blocks": 1}, {"max_steps": 12}),
    RGB: ({"num_envs": 16, "pool_refill": 2, "warmup_blocks": 1}, {"max_steps": 12}),
}


def tiny_run(cell: str, seconds: float) -> dict:
    wl, env = TINY[cell]
    return R.run(cell, SEED, seconds, False, device="cpu",
                 overrides={**wl, "sample_every": 1, "sample_cap": 6}, env_overrides=env)


@pytest.mark.parametrize("cell", [OM, RGB])
def test_tiny_run_is_correct(cell):
    res = tiny_run(cell, 0.5)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["compared"]["value"] >= 2 * TINY[cell][0]["num_envs"]


def test_unblanked_frames_make_obs_wrong(monkeypatch):
    from minigrid_tpu_torch.ops import render

    view = render.gen_obs_grid_batch

    def all_visible(states, params):
        cells, vis = view(states, params)
        return cells, torch.ones_like(vis)

    monkeypatch.setattr(render, "gen_obs_grid_batch", all_visible)
    res = tiny_run(RGB, 0.3)
    assert not res["correct"]
    assert res["checks"]["obs_wrong"]["value"] > 0


def test_dropped_box_contents_make_start_and_ring_wrong(monkeypatch):
    from minigrid_tpu_torch.core.state import empty_grid
    from minigrid_tpu_torch.envs import obstructedmaze as OMP

    finish = OMP.ObstructedMazeEnv.finish

    def dropped(self, b, keys):
        n, w, h = b["grid"].shape
        return finish(self, {**b, "box_contains": empty_grid(w, h, keys.device, (n,))}, keys)

    monkeypatch.setattr(OMP.ObstructedMazeEnv, "finish", dropped)
    res = tiny_run(OM, 0.3)
    assert not res["correct"]
    assert res["checks"]["start_wrong"]["value"] > 0
    assert res["checks"]["ring_wrong"]["value"] > 0


READERS = ("obstructedmaze.doors_ms", "render.pov_ms", "render_pov_roofline")


def test_readers_read_none_without_the_program_spans(monkeypatch):
    run = SimpleNamespace(trace_steps=4, kernel_inputs={"render_pov": None})
    for report in (lambda: None, lambda: {"spans": {}, "counters": {}}):
        monkeypatch.setattr(program, "report", report)
        for metric in READERS:
            assert R.reader(metric)(run) is None, metric


def test_readers_read_the_traced_steps():
    """One traced step of each cell's program at a small batch: the span
    readers read what it recorded; the roofline reads the render pass's
    bytes over its device time."""
    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.utils import trace
    from minigrid_tpu_torch.wrappers import RGBImgPartialObsWrapper

    om = mgt.make("MiniGrid-ObstructedMaze-Full-v0")
    rgb = RGBImgPartialObsWrapper(mgt.make("MiniGrid-DoorKey-8x8-v0"), tile_size=8)
    run = SimpleNamespace(trace_steps=1)
    for env, metric in ((om, "obstructedmaze.doors_ms"), (rgb, "render.pov_ms")):
        venv = mgt.VectorEnv(env, 16, reset_strategy="pooled", device="cpu")
        _, state = venv.reset(rng.PRNGKey(5, "cpu"))
        trace.reset()
        trace.enable()
        try:
            venv.step(state, torch.randint(0, 8, (16,), dtype=torch.int32))
            assert R.reader(metric)(run) > 0
        finally:
            trace.disable()
            trace.reset()
    frames, view, tile = 4096, 7, 8
    least = (frames * 56 * 56 * 3 + frames * 49 * 8 + 10 * 1122 * 192) / 3.35e12
    x = {"device_s": 4 * least, "calls": 1, "frames": frames, "view": view, "tile": tile}
    assert R.reader("render_pov_roofline")(
        SimpleNamespace(kernel_inputs={"render_pov": x})) == pytest.approx(25.0)


def test_span_device_time_counts_the_launches_inside_the_span():
    def host(name, ts, dur, cat="user_annotation", tid=1, corr=None):
        return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
                "args": {} if corr is None else {"correlation": corr}}

    def device(ts, dur, corr, cat="kernel"):
        return {"name": "k", "cat": cat, "ts": ts, "dur": dur, "tid": 7,
                "args": {"correlation": corr}}

    events = [
        host("render.pov", 100, 50), host("render.pov", 300, 50),
        host("cudaLaunchKernel", 110, 2, "cuda_runtime", corr=1),
        host("cudaMemcpyAsync", 340, 2, "cuda_runtime", corr=2),
        host("cudaLaunchKernel", 200, 2, "cuda_runtime", corr=3),   # between the spans
        host("cudaLaunchKernel", 120, 2, "cuda_runtime", tid=2, corr=4),  # another thread
        device(400, 10, 1), device(410, 6, 2, "gpu_memcpy"), device(420, 30, 3),
        device(460, 40, 4),
    ]
    assert span_device.seconds_inside(events, "render.pov") == pytest.approx(16e-6)
    assert span_device.seconds_inside(events, "vector.observe") is None
