"""Episodes from a seed-exact reset: the port's ``Env.step`` against the JAX
package's jitted ``step``, in lockstep, one MiniGrid id per generator of
``utils/exact.py``.

Both sides start from their own ``reset_exact`` (held equal to each other in
``test_torch_exact_minigrid.py``) and take 16 steps of the same numpy-seeded
actions with no auto-reset, as the Gymnasium adapter does.  Every step's
observation, reward (as float32 bits), terminated and truncated agree, and
so does the final state.  The JAX step is jitted at the default
optimization level: its reward is one fused multiply-add there, as in the
port.  The BabyAI generators are in ``test_torch_exact_step_babyai.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.utils.exact import reset_exact as j_reset_exact

import minigrid_tpu_torch
from minigrid_tpu_torch.utils.convert import state_to_numpy
from minigrid_tpu_torch.utils.exact import reset_exact

from tests.test_torch_bridge import _assert_fields, jax_to_numpy
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_exact_minigrid import row0

CPU = torch.device("cpu")
STEPS = 16

# one id per MiniGrid generator (Crossing with both obstacle types)
MINIGRID_STEP_IDS = [
    "MiniGrid-Empty-Random-6x6-v0", "MiniGrid-DoorKey-5x5-v0", "MiniGrid-LavaGapS5-v0",
    "MiniGrid-FourRooms-v0", "MiniGrid-LavaCrossingS9N1-v0",
    "MiniGrid-SimpleCrossingS9N2-v0", "MiniGrid-DistShift1-v0", "MiniGrid-GoToDoor-5x5-v0",
    "MiniGrid-Fetch-5x5-N2-v0", "MiniGrid-GoToObject-6x6-N2-v0",
    "MiniGrid-PutNear-6x6-N2-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0",
    "MiniGrid-RedBlueDoors-6x6-v0", "MiniGrid-MemoryS7-v0", "MiniGrid-LockedRoom-v0",
    "MiniGrid-MultiRoom-N2-S4-v0", "MiniGrid-Negated-Simple-v0", "MiniGrid-Playground-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0", "MiniGrid-ObstructedMaze-2Dl-v0",
    "MiniGrid-KeyCorridorS3R1-v0", "MiniGrid-Unlock-v0", "MiniGrid-UnlockPickup-v0",
    "MiniGrid-BlockedUnlockPickup-v0",
]


def check_lockstep(env_id: str, seed: int = 0, steps: int = STEPS) -> None:
    jenv, env = minigrid_tpu.make(env_id), minigrid_tpu_torch.make(env_id)
    jparams, params = jenv.default_params, env.default_params
    j_step = jax.jit(lambda s, a: jenv.step(s, a, jparams))
    _, jstate = j_reset_exact(jenv, seed)
    _, state = reset_exact(env, seed, device=CPU)
    actions = np.random.default_rng(seed).integers(0, env.num_actions, steps)
    for t, a in enumerate(actions):
        where = f"{env_id} step {t}"
        jobs, jstate, jr, jterm, jtrunc, _ = j_step(jstate, jnp.int32(a))
        obs, state, r, term, trunc, _ = env.step(
            state, torch.tensor([a], dtype=torch.int32), params)
        for k in jobs:
            np.testing.assert_array_equal(obs[k][0].numpy(), np.asarray(jobs[k]),
                                          err_msg=f"{where} {k}")
        assert r.dtype == torch.float32, where
        assert r[0].numpy().tobytes() == np.asarray(jr, np.float32).tobytes(), (
            where, float(r[0]), float(jr))
        assert bool(term[0]) == bool(jterm) and bool(trunc[0]) == bool(jtrunc), where
    _assert_fields(row0(state_to_numpy(state)), jax_to_numpy(jstate), f"{env_id} final ")


@pytest.mark.parametrize("env_id", MINIGRID_STEP_IDS)
def test_exact_reset_then_step_matches_jax(env_id):
    check_lockstep(env_id)
