"""Writing your own environment on the PyTorch port — the `_gen_grid` tutorial.

The port's copy of ``examples/custom_env.py``.  The reference teaches
extension by subclassing ``MiniGridEnv`` and writing ``_gen_grid`` plus an
optional ``step`` override (every env in minigrid/envs/ follows that recipe,
e.g. envs/fetch.py).  Here the same two hooks exist in batch-first form:

* ``generate(keys, params, device) -> EnvState`` — the ``_gen_grid``
  analogue: one level per key of ``keys`` (int64[N, 2]), built with the
  masked-select grid ops of ``core.grid_ops`` on a whole batch at once, its
  draws from ``core.rng`` (the threefry twin of ``jax.random``, so the
  levels are the JAX example's, bit for bit).
* ``post_step(state, action, reward, terminated, outcome, params)`` — the
  ``step``-override analogue: task reward/termination, applied after the
  base transition (movement/pickup/toggle/lava/goal semantics come free).

This example builds **LavaCourier**, a task that is NOT in the reference:
a vertical lava curtain with one random gap splits the room; the purple
ball spawns on the far side; picking it up ends the episode with the
standard time-discounted reward.  Everything composes unchanged:
vectorized auto-reset rollouts, wrappers, rendering, and PPO.

Run on the card (``--device cpu`` for the CPU):

    python examples/custom_env_torch.py
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import (EnvParams, EnvState, base_state,
                                           empty_grid, resolve_device)
from minigrid_tpu_torch.core.step import StepOutcome

BALL_T = C.OBJECT_TO_IDX["ball"]
PURPLE = C.COLOR_TO_IDX["purple"]
BALL_TRIPLE = np.array([BALL_T, PURPLE, 0], dtype=np.uint8)


class LavaCourierEnv(Env):
    """Cross the lava gap, pick up the purple ball."""

    name = "LavaCourier"

    def __init__(self, size: int = 9, max_steps: int | None = None, **kw):
        super().__init__(
            grid_size=size,
            max_steps=max_steps if max_steps is not None else 4 * size**2,
            see_through_walls=True,
            **kw,
        )

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        w, h = params.width, params.height
        k_gap, k_ball, k_agent, k_dir, k_rng = rng.split(keys, 5).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)

        # Lava curtain down the middle with one uniform-random gap: the gap's
        # row is one value per level, and put writes each level's own cell.
        mid = w // 2
        gap_y = rng.randint(k_gap, (), 1, h - 1)
        grid = G.vert_wall(grid, mid, 1, h - 2, C.LAVA_TRIPLE)
        grid = G.put(grid, mid, gap_y, C.EMPTY_TRIPLE)

        # Ball on the far side, agent on the near side: (top, size) windows
        # restrict the uniform draw exactly like the reference's place_obj
        # rectangles (minigrid_env.py:312-371).
        grid, ball_pos, _ = G.place_obj(
            k_ball, grid, BALL_TRIPLE, top=(mid + 1, 1),
            size=(w - mid - 2, h - 2))
        _, agent_pos, _ = G.place_obj(
            k_agent, grid, None, top=(1, 1), size=(mid - 1, h - 2))
        agent_dir = rng.randint(k_dir, (), 0, 4)
        return base_state(grid, agent_pos, agent_dir, rng=k_rng,
                          has_boxes=False)

    def post_step(self, state: EnvState, action, reward, terminated,
                  outcome: StepOutcome, params: EnvParams):
        # Same shape as the reference task overrides (e.g. fetch.py:162-176):
        # inspect the post-transition state, adjust reward/termination.
        got_ball = state.carrying[:, 0].to(torch.int32) == BALL_T
        reward = torch.where(got_ball, self.task_reward(state, params), reward)
        return state, reward, terminated | got_ball

    def mission_text(self, mission) -> str:
        return "cross the lava and pick up the purple ball"


# Registering makes the id work everywhere an id works: make / make_vec /
# the Gymnasium adapter / tools (benchmark, autotune, gen_docs, oracle).
minigrid_tpu_torch.register("MiniGrid-LavaCourier-9x9-v0", LavaCourierEnv, size=9)


def main(argv=None) -> None:
    from minigrid_tpu_torch.parallel.vector import rollout

    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    dev = resolve_device(p.parse_args(argv).device)

    env = minigrid_tpu_torch.make("MiniGrid-LavaCourier-9x9-v0")
    state, traj = rollout(env, env.default_params, rng.PRNGKey(0, dev),
                          num_envs=256, num_steps=324, device=dev)
    r = traj["reward"].cpu().numpy()
    term = traj["terminated"].cpu().numpy()
    print(f"256 envs x 324 random steps: {term.sum()} terminations "
          f"(ball pickups or lava), mean terminal reward "
          f"{r[term].mean():.3f}")

    # The standard Gymnasium surface works too, where gymnasium is installed:
    try:
        from minigrid_tpu_torch.gym_compat import GymEnv
    except ImportError:
        print("gymnasium is not installed: the Gymnasium adapter is skipped")
        return
    genv = GymEnv(env, device=dev)
    obs, _ = genv.reset(seed=0)
    print("gym obs keys:", sorted(obs), "| mission:", obs["mission"])


if __name__ == "__main__":
    main()
