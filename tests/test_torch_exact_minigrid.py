"""Seed-exact generation (``utils/exact.py``) against the JAX package's: the
MiniGrid ids, the registry, and the numpy generator.

``reset_exact(env, seed)`` replays the reference's ``np_random`` call order
on the host.  For every supported id at seeds 0 and 1, the port's state (as
numpy, row 0 of its batch of one) and observation equal the JAX package's
``reset_exact`` bit for bit, every field in value and dtype.  The BabyAI ids
are in ``test_torch_exact_babyai_a_k.py`` and ``..._l_z.py``, so that
``--dist loadfile`` spreads the JAX side's work; their checks use
:func:`check_exact` from here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_tpu
from minigrid_tpu.utils.exact import reset_exact as j_reset_exact
from minigrid_tpu.utils.exact import supported as j_supported

import minigrid_tpu_torch
from minigrid_tpu_torch.utils.convert import state_to_numpy
from minigrid_tpu_torch.utils.exact import _np_random, reset_exact, supported

from tests.test_torch_bridge import PORT_ID_COUNT, _assert_fields, jax_to_numpy
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
SEEDS = (0, 1)
# not seed-deterministic upstream (global random / np.random, split iterators)
DATASET_IDS = ["BlocksDataset-v0", "ContrastiveDataset-v0",
               "ContrastiveTrajectoryDataset-v0", "DirectionsDataset-v0"]
EXACT_IDS = [i for i in minigrid_tpu_torch.registered_ids() if i not in DATASET_IDS]
MINIGRID_IDS = [i for i in EXACT_IDS if not i.startswith("BabyAI-")]
BABYAI_IDS = [i for i in EXACT_IDS if i.startswith("BabyAI-")]


def row0(tree):
    """Row 0 of every array of a numpy field dict (a batch of one)."""
    if isinstance(tree, dict):
        return {k: row0(v) for k, v in tree.items()}
    return None if tree is None else tree[0]


def check_exact(env_id: str, seeds=SEEDS) -> None:
    """The port's ``reset_exact`` equals JAX's on every seed: the state,
    field by field, and every observation leaf."""
    jenv, env = minigrid_tpu.make(env_id), minigrid_tpu_torch.make(env_id)
    for seed in seeds:
        jobs, jstate = j_reset_exact(jenv, seed)
        obs, state = reset_exact(env, seed, device=CPU)
        assert state.grid.shape[0] == 1, "a batch of one"
        _assert_fields(row0(state_to_numpy(state)), jax_to_numpy(jstate),
                       f"{env_id} seed {seed}: ")
        assert set(obs) == set(jobs), env_id
        for k, v in obs.items():
            want = np.asarray(jobs[k])
            got = v[0].numpy()
            assert got.dtype == want.dtype, (env_id, seed, k, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"{env_id} seed {seed} {k}")


@pytest.mark.parametrize("env_id", MINIGRID_IDS)
def test_exact_minigrid_matches_jax(env_id):
    check_exact(env_id)


def test_supported_refuses_exactly_the_dataset_ids():
    assert len(minigrid_tpu_torch.registered_ids()) == PORT_ID_COUNT
    refused = sorted(i for i in minigrid_tpu_torch.registered_ids()
                     if not supported(minigrid_tpu_torch.make(i)))
    assert refused == DATASET_IDS
    jax_refused = sorted(i for i in minigrid_tpu.registered_ids()
                         if not j_supported(minigrid_tpu.make(i)))
    assert refused == jax_refused
    assert len(EXACT_IDS) == 167


@pytest.mark.parametrize("env_id", DATASET_IDS)
def test_dataset_ids_raise_not_implemented(env_id):
    with pytest.raises(NotImplementedError, match="seed-exact"):
        reset_exact(minigrid_tpu_torch.make(env_id), 0, device=CPU)
    with pytest.raises(NotImplementedError, match="seed-exact"):
        j_reset_exact(minigrid_tpu.make(env_id), 0)


def test_numpy_generator_is_gymnasiums():
    """The Generator built from numpy alone draws gymnasium's
    ``seeding.np_random`` stream: integers, floats, shuffles, choices."""
    seeding = pytest.importorskip("gymnasium.utils.seeding")
    for seed in (0, 1, 7, 2**31 + 5, 2**40 + 3):
        ours, (theirs, _) = _np_random(seed), seeding.np_random(seed)
        np.testing.assert_array_equal(ours.integers(0, 1000, 64), theirs.integers(0, 1000, 64))
        assert ours.uniform(0.0, 1.0) == theirs.uniform(0.0, 1.0)
        a, b = list(range(20)), list(range(20))
        ours.shuffle(a)
        theirs.shuffle(b)
        assert a == b
        assert int(ours.choice(range(3, 17))) == int(theirs.choice(range(3, 17)))
    for bad in (-1, 1.5, np.int64(3)):
        with pytest.raises(ValueError, match="seed"):
            _np_random(bad)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reset_exact(minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0"), 0)
