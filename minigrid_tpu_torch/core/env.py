"""Functional environment base class, batch-first.

Counterpart of ``minigrid_tpu/core/env.py``.  An :class:`Env` holds only
static configuration; all episode state lives in an :class:`EnvState` batch.
Every method works on a whole batch of envs:

    obs, state                  = env.reset(keys, params)       # keys [N, 2]
    obs, state, r, t, tr, info  = env.step(state, actions, params)
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.constants import TILE_PIXELS
from minigrid_tpu_torch.core.obs import gen_obs_batch
from minigrid_tpu_torch.core.state import EnvParams, EnvState
from minigrid_tpu_torch.core.step import (
    NUM_ACTIONS,
    StepOutcome,
    base_step,
    episode_limit,
    goal_reward,
)


class Env:
    """Base functional env.  Subclasses implement :meth:`generate` and may
    override :meth:`post_step` for task rewards and termination.

    A family may declare ``expensive_generation``, ``desynchronized_resets``
    and ``pool_refill_fraction`` as class attributes; the batch engine reads
    them with ``getattr`` to choose its reset strategy, as the JAX package's
    does, so the base class defines none of them."""

    name: str = "MiniGridEnv"
    num_actions: int = NUM_ACTIONS

    def __init__(
        self,
        grid_size: int | None = None,
        width: int | None = None,
        height: int | None = None,
        max_steps: int = 100,
        see_through_walls: bool = False,
        agent_view_size: int = 7,
        **kwargs: Any,
    ):
        if grid_size is not None:
            if width is not None or height is not None:
                raise ValueError("pass grid_size or width/height, not both")
            width = height = grid_size
        if width is None or height is None:
            raise ValueError("grid size missing")
        if agent_view_size % 2 != 1 or agent_view_size < 3:
            raise ValueError("agent_view_size must be odd and >= 3")
        self.width = width
        self.height = height
        self.max_steps = max_steps
        self.see_through_walls = see_through_walls
        self.agent_view_size = agent_view_size

    @property
    def default_params(self) -> EnvParams:
        return EnvParams(
            width=self.width,
            height=self.height,
            max_steps=self.max_steps,
            agent_view_size=self.agent_view_size,
            see_through_walls=self.see_through_walls,
        )

    # -- episode generation ------------------------------------------------
    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        """One fresh episode per key of ``keys`` (int64[N, 2]), on
        ``device`` (CUDA unless named)."""
        raise NotImplementedError

    def reset(self, keys: torch.Tensor, params: EnvParams,
              device=None) -> tuple[dict, EnvState]:
        state = self.generate(keys, params, device)
        return self.observation(state, params), state

    # -- transition --------------------------------------------------------
    def step_state(
        self, state: EnvState, action: torch.Tensor, params: EnvParams
    ) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Transition without observation."""
        state, reward, terminated, truncated, outcome = base_step(
            state, action, params)
        state, reward, terminated = self.post_step(
            state, action, reward, terminated, outcome, params)
        state = state.replace(terminated=terminated)
        return state, reward, terminated, truncated

    def step(self, state: EnvState, action: torch.Tensor, params: EnvParams):
        state, reward, terminated, truncated = self.step_state(state, action, params)
        obs = self.observation(state, params)
        return obs, state, reward, terminated, truncated, {}

    def post_step(
        self,
        state: EnvState,
        action: torch.Tensor,
        reward: torch.Tensor,
        terminated: torch.Tensor,
        outcome: StepOutcome,
        params: EnvParams,
    ) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
        """Task-specific reward/termination hook; default: base semantics."""
        return state, reward, terminated

    # -- observation -------------------------------------------------------
    def observation(self, states: EnvState, params: EnvParams) -> dict:
        return gen_obs_batch(states, params)

    def observation_batch(self, states: EnvState, params: EnvParams) -> dict:
        """The observation the batch layer asks for; families that override
        :meth:`observation` get their own definition here."""
        return self.observation(states, params)

    # -- reward helper -----------------------------------------------------
    def task_reward(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        return goal_reward(state.step_count, episode_limit(state, params))

    # -- missions ----------------------------------------------------------
    def mission_text(self, mission) -> str:
        """One env's packed mission code as the reference's string."""
        return ""

    def mission_codes(self) -> np.ndarray:
        """Every mission code this env can emit, int32[M, 4]; by default the
        single zero code of a fixed-mission env."""
        return np.zeros((1, 4), dtype=np.int32)

    # -- rendering ---------------------------------------------------------
    def get_frame(self, states: EnvState, params: EnvParams, highlight: bool = True,
                  tile_size: int = TILE_PIXELS, agent_pov: bool = False) -> torch.Tensor:
        """RGB frame of every env's whole grid, uint8[B, H*T, W*T, 3], or of
        its POV (MiniGridEnv.get_frame, minigrid_env.py:717-740)."""
        from minigrid_tpu_torch.ops.render import get_frame

        return get_frame(states, params, highlight=highlight, tile_size=tile_size,
                         agent_pov=agent_pov)

    # -- convenience -------------------------------------------------------
    def split_rng(self, state: EnvState) -> tuple[EnvState, torch.Tensor]:
        """Draw one subkey per env from the state's stream (for stochastic
        steps): ``rng, sub = split(rng)``."""
        keys, sub = rng.split(state.rng).unbind(-2)
        return state.replace(rng=keys), sub
