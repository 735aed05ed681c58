"""The port's BabyAI Open and Pickup levels against the JAX package, and the
checks over the whole BabyAI slice.

Every one of the 13 Open and 5 Pickup ids generates, from 32 threefry keys,
bitwise the levels of the jitted JAX ``env.generate``, with
``mission_text`` equal to the JAX package's string (the helpers and the
compile options are ``tests/test_torch_babyai_generate_goto.py``'s).  Then
the slice as a whole: the registry holds the 71 earlier ids, the 49 BabyAI
ids of ``goto.py``, ``open.py`` and ``pickup.py`` and those of the later
slices, every id of the JAX registry; the state
bridge carries a BabyAI state's ``extra`` (bool, int32 and uint32 leaves)
both ways; a BabyAI ``make_vec`` without ``device`` needs a card.  (That
no module of the port, ``babyai/`` included, imports JAX or the JAX
package is ``tests/test_torch_kernels.py``'s import walk.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.babyai import verifier as JV

import minigrid_tpu_torch
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.test_torch_babyai_generate_goto import (
    GOTO_IDS,
    INTEGER_PROGRAM,
    check_generate,
    check_generate_attempt,
    check_registry,
    check_strategy,
)
from tests.test_torch_bridge import _assert_fields, assert_registry_complete, jax_to_numpy
from tests.test_torch_zoo_generate import EARLIER_IDS, ZOO_IDS
from tests.test_torch_roomgrid_zoo import ROOMGRID_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

OPEN_IDS = ["BabyAI-Open-v0", "BabyAI-OpenRedDoor-v0", "BabyAI-OpenDoor-v0",
            "BabyAI-OpenDoorDebug-v0", "BabyAI-OpenDoorColor-v0",
            "BabyAI-OpenDoorLoc-v0", "BabyAI-OpenTwoDoors-v0",
            "BabyAI-OpenRedBlueDoors-v0", "BabyAI-OpenRedBlueDoorsDebug-v0",
            "BabyAI-OpenDoorsOrderN2-v0", "BabyAI-OpenDoorsOrderN4-v0",
            "BabyAI-OpenDoorsOrderN2Debug-v0", "BabyAI-OpenDoorsOrderN4Debug-v0"]
PICKUP_IDS = ["BabyAI-Pickup-v0", "BabyAI-UnblockPickup-v0", "BabyAI-PickupDist-v0",
              "BabyAI-PickupDistDebug-v0", "BabyAI-PickupAbove-v0"]
BABYAI_IDS = GOTO_IDS + OPEN_IDS + PICKUP_IDS


def test_the_babyai_slice_has_49_ids():
    """71 earlier ids, the 49 of this slice, the level generator's, PutNext,
    Unlock and other 46 (``tests/test_torch_babyai_levelgen.py``) and the
    five dataset envs: every id of the JAX registry."""
    from tests.test_torch_babyai_levelgen import SLICE_B_IDS
    from tests.test_torch_dataset_envs import DATASET_IDS

    assert len(OPEN_IDS) == 13 and len(PICKUP_IDS) == 5
    assert len(BABYAI_IDS) == 49 == len(set(BABYAI_IDS))
    assert minigrid_tpu_torch.registered_ids() == sorted(
        EARLIER_IDS + ZOO_IDS + ROOMGRID_IDS + BABYAI_IDS + SLICE_B_IDS + DATASET_IDS)
    assert_registry_complete()
    jax_babyai = {i for i in minigrid_tpu.registered_ids() if i.startswith("BabyAI-")}
    assert set(BABYAI_IDS) | set(SLICE_B_IDS) == jax_babyai


@pytest.mark.parametrize("env_id", OPEN_IDS + PICKUP_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


@pytest.mark.parametrize("env_id", OPEN_IDS + PICKUP_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


@pytest.mark.parametrize("env_id,seed", [("BabyAI-OpenRedDoor-v0", 4),
                                         ("BabyAI-PickupDist-v0", 5)])
def test_generate_attempt_matches_jax(env_id, seed):
    """The Open and Pickup families' attempts (levels without a validity
    test: every draw is valid; GoToRedBall's rejects some,
    ``tests/test_torch_babyai_generate_goto.py``)."""
    assert check_generate_attempt(env_id, seed).all()


def test_unblockpickup_rejects_reachable_levels():
    """UnblockPickup keeps only levels where some object is walled off, so
    most attempts are rejected and ``generate`` retries; an env still
    rejected after 8 passes keeps its last draw (the JAX package's too,
    held by ``test_generate_matches_jax``)."""
    env = minigrid_tpu_torch.make("BabyAI-UnblockPickup-v0")
    keys = torch.from_numpy(np.asarray(jax.random.split(jax.random.PRNGKey(6), 32))
                            .astype(np.int64))
    _, ok = env.generate_attempt(keys, env.default_params, device="cpu")
    assert not ok.all()


@pytest.mark.parametrize("num_envs,expected", [(16, ("conditional", 16)),
                                               (4096, ("pooled", 16))])
def test_open_maze_strategy_as_jax_chooses(num_envs, expected):
    check_strategy("BabyAI-Open-v0", num_envs, expected)


def test_state_bridge_round_trips_a_babyai_state():
    """A JAX GoToObjS4 reset state whose tracked plane has bit 31 set
    (packed from a 32-high mask): JAX -> numpy -> port -> numpy, equal in
    value and dtype, leaf by leaf (bool, int32; uint32 planes int64 in the
    port)."""
    jenv = minigrid_tpu.make("BabyAI-GoToObjS4-v0")
    jp = jenv.default_params
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    jst = jax.jit(jax.vmap(lambda k: jenv.generate(k, jp))).lower(keys).compile(
        INTEGER_PROGRAM)(keys)
    vs = jst.extra["vs"]
    tall = np.zeros(vs.tracked1.shape + (32,), bool)
    tall[..., 31] = True
    tall[0, 0, 1, 5] = True
    vs = vs.replace(tracked1=JV.pack_planes(jnp.asarray(tall)))
    jst = jst.replace(extra={**jst.extra, "vs": vs})
    fields = jax_to_numpy(jst)
    assert fields["extra"]["vs"]["tracked1"].dtype == np.uint32
    assert int(fields["extra"]["vs"]["tracked1"].max()) >= 1 << 31
    port = state_from_numpy(fields, "cpu")
    leaves = port.extra["vs"]
    assert leaves["tracked1"].dtype == torch.int64
    assert leaves["carry1"].dtype == torch.bool
    assert leaves["a_packed"].dtype == torch.int32
    assert port.extra["instr"]["strict"].dtype == torch.bool
    _assert_fields(state_to_numpy(port), fields, "round trip: ")


def test_make_vec_needs_a_card_without_device():
    """The default device is CUDA: without a card it raises."""
    if torch.cuda.is_available():
        assert minigrid_tpu_torch.make_vec("BabyAI-GoToRedBall-v0", 64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            minigrid_tpu_torch.make_vec("BabyAI-GoToRedBall-v0", 64)
    venv = minigrid_tpu_torch.make_vec("BabyAI-GoToRedBall-v0", 64, device="cpu")
    assert venv.device.type == "cpu"
