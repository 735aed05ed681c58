"""Uniform random actions through ``VectorEnv``'s pooled engine, every
observation an RGB frame of the agent's view: the env wrapped in
``RGBImgPartialObsWrapper(tile_size)``, uint8[B, V T, V T, 3].

Blocks, the ring and the check are ``vector_random``'s; the check compares
each sampled observation's frame, pixel for pixel, with the reference's
rendering of its own state (``perfbench/reference/render.py``).  The traced
run first profiles ``trace_blocks`` blocks on their own to read the device
time of the operations inside the program's span ``render.pov``
(``harness/span_device.py``), then traces ``trace_blocks`` more as
``vector_random`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers import vector_random as VR
from perfbench.harness import span_device
from perfbench.harness import state as S
from perfbench.reference import render as RR


class Driver(VR.Driver):
    def __init__(self, cfg: dict, wl: dict, seed: int, device, traced: bool = False):
        import minigrid_tpu_torch as mgt
        from minigrid_tpu_torch.wrappers import RGBImgPartialObsWrapper

        super().__init__(cfg, wl, seed, device, traced)
        self.tile_size = wl["tile_size"]
        self.env = RGBImgPartialObsWrapper(self.env, tile_size=self.tile_size)
        self.venv = mgt.VectorEnv(self.env, self.num_envs, reset_strategy="pooled",
                                  pool_refill=wl.get("pool_refill"), device=device)
        self.kernel_inputs["render_pov"] = None

    def _obs_wrong(self, ref: dict, obs: dict) -> np.ndarray:
        frames = RR.pov_frames(ref, self.venv.params.agent_view_size, self.tile_size)
        return (S.rows_differ(frames, obs["image"]) | (ref["dir"] != obs["direction"])
                | S.rows_differ(ref["mission"], obs["mission"]))

    def profile_body(self):
        """On a card, ``vector_random``'s traced blocks once under a profiler
        of their own for the render's device time, then again for the
        window; an RGB observation gathers its window twice (the wrapped
        env's symbolic view and the frame's), so each pose stands for two
        gathers."""
        if torch.device(self.device).type == "cuda":
            render_pass, _, _ = super().profile_body()
            got = span_device.measure(render_pass, "render.pov")
            if got is not None and "render.frames" in got["counters"]:
                self.kernel_inputs["render_pov"] = {
                    "device_s": got["device_s"], "calls": got["calls"],
                    "frames": got["counters"]["render.frames"],
                    "view": self.venv.params.agent_view_size, "tile": self.tile_size}
        body, steps, inputs = super().profile_body()

        def both():
            inputs()
            self.kernel_inputs["obs_gather"] = [
                x for x in self.kernel_inputs["obs_gather"] for _ in range(2)]

        return body, steps, both
