"""The port's level generator, ``LevelGen``, and its ten ids against the JAX
package: GoToSeq, GoToSeqS5R2, PickupLoc, Synth, SynthS5R2, SynthLoc,
SynthSeq, MiniBossLevel, BossLevel and BossLevelNoUnlock.

* every id's registry entry; ``generate`` of GoToSeq, GoToSeqS5R2 and
  PickupLoc bitwise on 32 keys against the jitted JAX generator (grid, box
  planes, agent, mission, per-episode ``max_steps``, the state's key, the
  instruction code and verifier state) with the JAX package's mission
  strings (the checks of ``tests/test_torch_babyai_generate_goto.py``; the
  Synth ids in ``tests/test_torch_babyai_synth.py``, the Boss ids in
  ``tests/test_torch_babyai_boss.py``); ``generate_attempt`` on
  MiniBossLevel;
* ``LevelGen._rand_objs`` held directly against JAX's on the same builders
  over 256 keys (SynthLoc: locations; Synth: ``implicit_unlock=False``
  with a locked room in some levels), with the port's count of redraws per
  lane: some lanes redraw twice or more and one uses the whole fuel of 24;
* the reset strategy and refill window the JAX package picks.

The id lists of the whole slice (this file's, PutNext, Unlock, other) live
here; ``tests/test_torch_babyai_putnext.py``, ``..._putnext_carrying.py``,
``..._unlock.py``, ``..._other.py`` and ``..._keycorridor.py`` hold the rest
of its generators.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu

import minigrid_tpu_torch
from minigrid_tpu_torch.babyai.levelgen import DESC_FUEL, LevelGen
from minigrid_tpu_torch.core import rng

from tests.test_torch_babyai_generate_goto import (
    INTEGER_PROGRAM,
    check_generate,
    check_generate_attempt,
    check_registry,
    check_strategy,
)
from tests.test_torch_zoo_generate import port_keys
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

LEVELGEN_IDS = ["BabyAI-GoToSeq-v0", "BabyAI-GoToSeqS5R2-v0", "BabyAI-PickupLoc-v0",
                "BabyAI-Synth-v0", "BabyAI-SynthS5R2-v0", "BabyAI-SynthLoc-v0",
                "BabyAI-SynthSeq-v0", "BabyAI-MiniBossLevel-v0", "BabyAI-BossLevel-v0",
                "BabyAI-BossLevelNoUnlock-v0"]
PUTNEXT_IDS = (["BabyAI-PutNextLocal-v0", "BabyAI-PutNextLocalS5N3-v0",
                "BabyAI-PutNextLocalS6N4-v0"]
               + [f"BabyAI-PutNextS{s}N{n}-v0" for s, n in
                  ((4, 1), (5, 2), (5, 1), (6, 3), (7, 4))]
               + [f"BabyAI-PutNextS{s}N{n}Carrying-v0" for s, n in
                  ((5, 2), (6, 3), (7, 4))])
UNLOCK_IDS = ["BabyAI-Unlock-v0", "BabyAI-UnlockLocal-v0", "BabyAI-UnlockLocalDist-v0",
              "BabyAI-KeyInBox-v0", "BabyAI-UnlockPickup-v0", "BabyAI-UnlockPickupDist-v0",
              "BabyAI-BlockedUnlockPickup-v0", "BabyAI-UnlockToUnlock-v0"]
OTHER_IDS = (["BabyAI-ActionObjDoor-v0"]
             + [f"BabyAI-FindObjS{s}-v0" for s in (5, 6, 7)]
             + ["BabyAI-KeyCorridor-v0"]
             + [f"BabyAI-KeyCorridorS{s}R{r}-v0" for s, r in
                ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3))]
             + [f"BabyAI-OneRoomS{s}-v0" for s in (8, 12, 16, 20)]
             + ["BabyAI-MoveTwoAcrossS5N2-v0", "BabyAI-MoveTwoAcrossS8N9-v0"])
SLICE_B_IDS = LEVELGEN_IDS + PUTNEXT_IDS + UNLOCK_IDS + OTHER_IDS


def test_slice_b_has_46_ids():
    assert [len(x) for x in (LEVELGEN_IDS, PUTNEXT_IDS, UNLOCK_IDS, OTHER_IDS)] == [
        10, 11, 8, 17]
    assert len(SLICE_B_IDS) == 46 == len(set(SLICE_B_IDS))
    assert set(SLICE_B_IDS) <= set(minigrid_tpu.registered_ids())
    assert set(SLICE_B_IDS) <= set(minigrid_tpu_torch.registered_ids())
    for env_id in LEVELGEN_IDS:
        assert isinstance(minigrid_tpu_torch.make(env_id), LevelGen)


@pytest.mark.parametrize("env_id", LEVELGEN_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    for attr in ("num_dists", "locked_room_prob", "locations", "unblocking",
                 "implicit_unlock", "action_kinds", "instr_kinds"):
        assert getattr(env, attr) == getattr(jenv, attr), attr


# the rest of LEVELGEN_IDS: tests/test_torch_babyai_synth.py and
# tests/test_torch_babyai_boss.py
@pytest.mark.parametrize("env_id", LEVELGEN_IDS[:3])
def test_generate_matches_jax(env_id):
    check_generate(env_id)


def test_generate_attempt_matches_jax():
    """MiniBossLevel's attempts: the validity flag (PutNext clauses next to
    their object, keys of a locked door's color, are rejected)."""
    ok = check_generate_attempt("BabyAI-MiniBossLevel-v0", 9)
    assert ok.any()


def _layout_and_kinds(env, keys: torch.Tensor):
    """The port's builder of each level before its instruction, and its
    four clause kinds."""
    k = rng.split(keys, 16).unbind(1)
    b, has_locked, locked_rect = env._layout(k, env.default_params)
    kinds = torch.stack([env._rand_action_kind(rng.fold_in(k[10], s))
                         for s in range(4)], dim=1)
    return k, b, has_locked, locked_rect, kinds


@pytest.mark.parametrize("env_id", ["BabyAI-SynthLoc-v0", "BabyAI-Synth-v0"])
def test_rand_objs_matches_jax(env_id):
    """The 8 descriptor lanes of 256 levels against JAX's ``_rand_objs`` on
    the same builders (the port's, turned into JAX arrays), same keys, same
    clause kinds."""
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jkeys = jax.random.split(jax.random.PRNGKey(7), 256)
    k, b, has_locked, locked_rect, kinds = _layout_and_kinds(env, port_keys(jkeys))
    d1, d2, redraws = env._rand_objs(k[11], k[12], b, env.default_params, locked_rect,
                                     has_locked, kinds)

    def one(kd1, kd2, grid, pos, direction, rect, locked, ck):
        builder = {"grid": grid, "agent_pos": pos, "agent_dir": direction}
        return jenv._rand_objs(kd1, kd2, builder, jp, rect, locked, ck)

    args = ([jnp.asarray(x.numpy().astype(np.uint32)) for x in (k[11], k[12])]
            + [jnp.asarray(x.numpy()) for x in (b["grid"], b["agent_pos"],
                                                b["agent_dir"], locked_rect,
                                                has_locked, kinds)])
    jd1, jd2 = jax.jit(jax.vmap(one)).lower(*args).compile(INTEGER_PROGRAM)(*args)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    assert d1.dtype == torch.int32 and d1.shape == (256, 4, 3)

    # the redraw loop ran: a locked room in some levels, lanes redrawn more
    # than once
    r = redraws.numpy()
    assert has_locked.any() and not has_locked.all()
    assert (r >= 2).any() and int(r.max()) <= DESC_FUEL
    if env_id == "BabyAI-SynthLoc-v0":
        # one lane in these 256 levels uses the whole fuel
        assert int(r.max()) == DESC_FUEL
        assert (d1[..., 2] > 0).any()  # locations


@pytest.mark.parametrize("env_id,num_envs,expected", [
    ("BabyAI-BossLevel-v0", 4096, ("pooled", 16)),
    ("BabyAI-MiniBossLevel-v0", 4096, ("pooled", 16)),
    ("BabyAI-PickupLoc-v0", 4096, ("pooled", 512)),
    ("BabyAI-SynthS5R2-v0", 16, ("conditional", 16))])
def test_strategy_as_jax_chooses(env_id, num_envs, expected):
    check_strategy(env_id, num_envs, expected)
