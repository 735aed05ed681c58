"""The port's RGB view (``RGBImgPartialObsWrapper`` over DoorKey-8x8, tile
8) against the benchmark's plain NumPy renderer
(``perfbench/reference/render.py``), pixel for pixel, on the CPU: a random
walk of the pooled engine, hand-built views with every door state, the
carried key and all four directions, and the control, a frame whose
invisible cells are drawn, which the comparison must catch.  Nothing here
imports JAX.

    python -m pytest tests/test_torch_rgb_reference.py -q
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.ops import render
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from minigrid_tpu_torch.wrappers import RGBImgPartialObsWrapper

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import state as S  # noqa: E402
from perfbench.reference import minigrid as M  # noqa: E402
from perfbench.reference import render as RR  # noqa: E402

CPU = torch.device("cpu")
TILE = 8
ENV = RGBImgPartialObsWrapper(mgt.make("MiniGrid-DoorKey-8x8-v0"), tile_size=TILE)
PARAMS = ENV.default_params
V = PARAMS.agent_view_size


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Under pytest-xdist, torch on one thread beside the other workers."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames_wrong(states, image) -> np.ndarray:
    """bool[B]: the frames that differ anywhere from the reference's."""
    want = RR.pov_frames(S.env_levels(states), V, TILE)
    return S.rows_differ(want, S.to_np(image))


def test_pooled_walk_frames_match_reference():
    """Every frame of 40 random steps of the pooled engine at B=16,
    episodes cut to 10 steps so that auto-resets serve new levels."""
    env = RGBImgPartialObsWrapper(mgt.make("MiniGrid-DoorKey-8x8-v0", max_steps=10),
                                  tile_size=TILE)
    venv = mgt.VectorEnv(env, 16, reset_strategy="pooled", pool_refill=2, device=CPU)
    obs, state = venv.reset(rng.PRNGKey(2**31 + 5, CPU))
    gen = torch.Generator().manual_seed(7)
    for t in range(40):
        assert obs["image"].shape == (16, V * TILE, V * TILE, 3)
        assert not _frames_wrong(state.envs, obs["image"]).any(), t
        action = torch.randint(0, 8, (16,), generator=gen, dtype=torch.int32)
        obs, state, *_ = venv.step(state, action)


def _views(door_state: int) -> object:
    """Four DoorKey views from one level: the agent carrying the yellow
    key, one cell left of the door (in ``door_state``), in each of the
    four directions."""
    fields = state_to_numpy(ENV.generate(torch.tensor([[0, 3]] * 4), PARAMS, CPU))
    grid = fields["grid"].astype(np.int64)
    door = np.argwhere(M.cell_type(grid[0]) == M.DOOR_T)[0]
    grid[:] = np.where(M.cell_type(grid) == M.KEY_T, M.EMPTY, grid)
    grid[:, door[0], door[1]] = M.pack(M.DOOR_T, M.YELLOW, door_state)
    carrying = np.array([[M.KEY_T, M.YELLOW, 0]] * 4, np.uint8)
    fields.update(grid=grid.astype(fields["grid"].dtype), carrying=carrying,
                  agent_pos=np.array([[door[0] - 1, door[1]]] * 4),
                  agent_dir=np.arange(4))
    return state_from_numpy(fields, CPU)


@pytest.mark.parametrize("door_state", [M.OPEN, M.CLOSED, M.LOCKED])
def test_built_views_match_reference(door_state):
    states = _views(door_state)
    image = ENV.observation_batch(states, PARAMS)["image"]
    assert not _frames_wrong(states, image).any()


def test_unblanked_frame_is_caught(monkeypatch):
    """The control: frames that draw the cells the agent cannot see differ
    from the reference's wherever a wall hides part of the view."""
    view = render.gen_obs_grid_batch

    def all_visible(states, params):
        cells, vis = view(states, params)
        return cells, torch.ones_like(vis)

    states = _views(M.LOCKED)
    want_ok = ENV.observation_batch(states, PARAMS)["image"]
    monkeypatch.setattr(render, "gen_obs_grid_batch", all_visible)
    image = ENV.observation_batch(states, PARAMS)["image"]
    assert not _frames_wrong(states, want_ok).any()
    assert _frames_wrong(states, image).any()
