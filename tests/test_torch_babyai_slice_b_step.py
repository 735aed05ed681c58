"""The level generator's, PutNext's, Unlock's and the other BabyAI levels
through the port's batch engine against the JAX package's, in lockstep,
through the auto-resets (``tests/test_torch_babyai_step.py``'s harness: both
engines start from the port's reset, same random actions, every step's
observation, reward bits and flags, and the final state with the verifier
state and box planes):

MiniBossLevel, PutNextS5N2Carrying (the carried start in every new
episode), KeyInBox (a key in a box) and MoveTwoAcrossS5N2 (two PutNext
clauses in sequence), B=32 ``conditional``, 24 steps at ``max_steps`` 8.
BossLevel pooled is in ``tests/test_torch_babyai_boss.py``.

Then a PutNext task path from teleported states: each carried object
dropped beside its target pays the task reward, in the port and in JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu

import minigrid_tpu_torch
from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.test_torch_babyai_step import babyai_jax_state, run_lockstep
from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_zoo_step import assert_step_equal
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")


@pytest.mark.parametrize("env_id,seed", [("BabyAI-MiniBossLevel-v0", 51),
                                         ("BabyAI-PutNextS5N2Carrying-v0", 52),
                                         ("BabyAI-KeyInBox-v0", 53),
                                         ("BabyAI-MoveTwoAcrossS5N2-v0", 54)])
def test_lockstep_matches_jax(env_id, seed):
    venv, rewards, ends, st = run_lockstep(env_id, 32, 24, seed, max_steps=8)
    assert venv.reset_strategy == "conditional"
    assert ends >= 2 * 32, ends
    if "Carrying" in env_id:
        # every episode starts with object A in hand
        fresh = st.step_count == 0
        assert fresh.any()
        assert (st.carrying[fresh, 0] != C.OBJECT_TO_IDX["empty"]).all()
    if "KeyInBox" in env_id:
        assert ((st.box_contains & 0xFF) == C.OBJECT_TO_IDX["key"]).any()


def _drop_beside_target(fields: dict, width: int, height: int) -> tuple[dict, np.ndarray]:
    """Teleport each agent so that the cell in front of it is empty and
    4-adjacent to an object matching the clause's fixed desc (type, color);
    returns the fields and the envs where such a pose exists."""
    grid = fields["grid"]
    d2 = fields["extra"]["instr"]["d2"][:, 0]
    pos = fields["agent_pos"].copy()
    dirs = fields["agent_dir"].copy()
    found = np.zeros(grid.shape[0], bool)
    types, colors = grid & 0xFF, (grid >> 8) & 0xFF
    want_type = V.DESC_TYPE_IDS[d2[:, 0]]
    for b in range(grid.shape[0]):
        empty = types[b] == C.OBJECT_TO_IDX["empty"]
        targets = np.argwhere((types[b] == want_type[b]) & (colors[b] == d2[b, 1]))
        for tx, ty in targets:
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                cx, cy = tx + dx, ty + dy
                if not (0 <= cx < width and 0 <= cy < height and empty[cx, cy]):
                    continue
                for d, (fx, fy) in enumerate(C.DIR_TO_VEC):
                    ax, ay = cx - fx, cy - fy
                    if 0 <= ax < width and 0 <= ay < height and empty[ax, ay]:
                        pos[b], dirs[b], found[b] = (ax, ay), d, True
                        break
                if found[b]:
                    break
            if found[b]:
                break
    return {**fields, "agent_pos": pos.astype(np.int32),
            "agent_dir": dirs.astype(np.int32)}, found


def test_putnext_carried_start_success_matches_jax():
    """PutNextS6N3Carrying: a step that changes nothing (``done``) records
    the carry, then a drop beside the fixed object pays the task reward and
    ends the episode, in the port and in the jitted JAX step alike."""
    env_id = "BabyAI-PutNextS6N3Carrying-v0"
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    start = state_to_numpy(env.generate(rng.split(rng.PRNGKey(56, CPU), 32),
                                        env.default_params, device="cpu"))
    fields, found = _drop_beside_target(start, env.width, env.height)
    assert found.sum() >= 16, found

    def step_both(fields, action, where):
        a = np.full(32, action, np.int32)
        jout = jstep(babyai_jax_state(fields), jnp.asarray(a))
        out = env.step(state_from_numpy(fields, CPU), torch.from_numpy(a),
                       env.default_params)
        assert_step_equal((out[0], out[2], out[3], out[4]),
                          (jout[0], jout[2], jout[3], jout[4]), where)
        assert_state_equal(out[1], jout[1], where)
        return state_to_numpy(out[1]), out[2].numpy(), out[3].numpy()

    fields, r, te = step_both(fields, 6, "done: ")
    assert not te.any() and (r == 0).all()
    assert fields["extra"]["vs"]["pre_carry1"][:, 0].all()
    fields, r, te = step_both(fields, 4, "drop: ")
    assert te[found].all() and (r[found] > 0).all()

