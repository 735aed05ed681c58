"""DoorKey: the base MiniGrid step, levels made exactly from their keys."""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M


def generate(keys: np.ndarray, cfg: dict) -> dict:
    """The levels of ``keys`` [N, 2], every field the configuration's state
    holds."""
    lvl = M.doorkey_generate(keys, cfg["env_kwargs"]["size"])
    n = keys.shape[0]
    lvl["mission"] = np.zeros((n, 4), np.int64)
    lvl["terminated"] = np.zeros(n, bool)
    lvl["truncated"] = np.zeros(n, bool)
    return lvl


def attempt(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """A refill's levels and whether each is accepted: DoorKey draws every
    level from its key alone, and accepts every draw."""
    return generate(keys, cfg), np.ones(keys.shape[0], bool)


def post_step(before: dict, after: dict, action, outcome, reward, terminated, cfg,
              reward_fn=M.goal_reward):
    """DoorKey's task is the goal: nothing beyond the base step."""
    return after, reward, terminated


def modelled(level: dict) -> dict:
    """The fields the reference computes for this task: all of them."""
    return level
