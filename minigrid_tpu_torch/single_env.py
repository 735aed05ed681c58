"""One env stepped from the host: the Gymnasium adapter's core, without
gymnasium.

:class:`SingleEnv` holds a batch of one :class:`EnvState` on a device (CUDA
unless ``device`` names another) and returns what the Gymnasium API
returns: numpy observations with the mission as its string, a float
reward, bool flags and the info dict, every step's outputs read back in one
copy (``utils/convert.to_host``).  :class:`minigrid_tpu_torch.gym_compat.GymEnv`
is this class under ``gymnasium.Env``, with the spaces, rendering and
registry; a machine without gymnasium drives this class directly::

    from minigrid_tpu_torch.single_env import SingleEnv

    env = SingleEnv("MiniGrid-DoorKey-8x8-v0")
    obs, info = env.reset(seed=0)
    obs, reward, terminated, truncated, info = env.step(2)

A reset draws from the threefry key stream of the JAX adapter (``key =
PRNGKey(seed)`` when seeded, then ``key, k = split(key)`` a reset);
``exact_seed=True`` makes ``reset(seed=s)`` the reference's level for ``s``
(``utils/exact.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.registry import make as make_functional
from minigrid_tpu_torch.utils.convert import to_host


class SingleEnv:
    """Stateful host adapter over a functional env: the current state, a
    batch of one, is the single mutable field."""

    def __init__(self, env: Env | str, exact_seed: bool = False, device=None,
                 **kwargs: Any):
        self.fenv = make_functional(env, **kwargs) if isinstance(env, str) else env
        self.params = self.fenv.default_params
        self.device = resolve_device(device)
        # exact_seed: reset(seed=s) replays the reference's np_random call
        # order on the host (utils/exact.reset_exact), so the episode is the
        # reference's for seed s.  Off by default: the batch generator is
        # the production path.
        self.exact_seed = exact_seed
        self._state = None
        self._key = rng.PRNGKey(0, self.device)

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if self.exact_seed and seed is not None:
            from minigrid_tpu_torch.utils.exact import reset_exact

            obs, self._state = reset_exact(self.fenv, seed, self.params, self.device)
            self._key = rng.PRNGKey(seed, self.device)
        else:
            if seed is not None:
                self._key = rng.PRNGKey(seed, self.device)
            self._key, k = rng.split(self._key).unbind(0)
            obs, self._state = self.fenv.reset(k[None], self.params, self.device)
        return self._host_obs(obs)[0], {}

    def step(self, action):
        a = torch.full((1,), int(action), dtype=torch.int32, device=self.device)
        obs, self._state, reward, term, trunc, info = self.fenv.step(
            self._state, a, self.params)
        out, (r, te, tr) = self._host_obs(obs, (reward, term, trunc))
        return out, float(r[0]), bool(te[0]), bool(tr[0]), dict(info)

    def _host_obs(self, obs: dict, more: tuple = ()) -> tuple[dict, list]:
        """The observation of env 0 as numpy (0-d leaves as np.int64, what
        Discrete spaces contain; the mission as its string), and the tensors
        of ``more`` as numpy: everything in one device-to-host copy."""
        arrays = to_host([v[0] for v in obs.values()] + list(more))
        out = {}
        for k, arr in zip(obs, arrays):
            if k == "mission":
                out[k] = self.fenv.mission_text(arr)
            else:
                out[k] = np.int64(arr) if arr.ndim == 0 else arr
        return out, arrays[len(obs):]
