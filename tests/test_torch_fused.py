"""The port's fused path against the JAX package's, on the CPU.

``FusedVectorEnv`` here takes the plain version of the fused step (CPU
tensors); the JAX ``FusedVectorEnv`` runs its Pallas kernel in interpret
mode, with the draws as an input.  For the same key and the same numpy
action stream the two agree bitwise on every lane and every step, the
auto-resets included: image, direction, reward bits, flags, grid, agent
plane, key and step index.  ``EmptyEnv.generate`` is held bitwise against
``jax.vmap(EmptyEnv.generate)``, and the fused reward against the compiled
JAX expression.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.ops.fused_step import FusedVectorEnv as JFusedVectorEnv

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.step import goal_reward
from minigrid_tpu_torch.envs import EmptyEnv
from minigrid_tpu_torch.ops import fused_step as F
from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
from minigrid_tpu_torch.utils.convert import fused_state_to_numpy

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
EMPTY_IDS = ["MiniGrid-Empty-5x5-v0", "MiniGrid-Empty-Random-5x5-v0",
             "MiniGrid-Empty-6x6-v0", "MiniGrid-Empty-Random-6x6-v0",
             "MiniGrid-Empty-8x8-v0", "MiniGrid-Empty-16x16-v0"]


def _keys(n: int, seed: int):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("env_id", EMPTY_IDS)
def test_empty_generate_matches_jax(env_id):
    jenv = minigrid_tpu.make(env_id)
    jk, tk = _keys(48, seed=len(env_id))
    want = jax.vmap(lambda k: jenv.generate(k, jenv.default_params))(jk)
    env = minigrid_tpu_torch.make(env_id)
    assert isinstance(env, EmptyEnv) and env.default_params.see_through_walls
    assert env.default_params.max_steps == 4 * env.width**2
    got = env.generate(tk, env.default_params, device="cpu")
    assert_state_equal(got, want)
    if env.agent_start_pos is None:  # random starts spread over the room
        assert len({tuple(p) for p in got.agent_pos.tolist()}) > 4
        assert len(set(got.agent_dir.tolist())) == 4


@pytest.mark.parametrize("max_steps", [7, 12, 100, 640, 1000, 2560])
def test_fused_reward_matches_the_compiled_jax_expression(max_steps):
    """The fused kernel's ``1 - 0.9 * c / M`` under jit, bitwise over every
    count c in 1..2M; ``goal_reward`` (base_step's rounding) is another
    function."""
    c = np.arange(1, 2 * max_steps + 1, dtype=np.int32)
    want = jax.jit(lambda c: 1.0 - 0.9 * c.astype(jnp.float32) / float(max_steps))(c)
    got = F.fused_goal_reward(torch.from_numpy(c), max_steps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    if max_steps == 640:
        base = goal_reward(torch.from_numpy(c), torch.full(c.shape, 640.0))
        assert int((base != got).sum()) > 100


def _assert_fused_step_equal(got, want, where: str) -> None:
    obs, fs, reward, term, trunc, info = got
    jobs, jfs, jreward, jterm, jtrunc, jinfo = want
    assert info == {} and jinfo == {}
    for k in ("image", "direction", "mission"):
        g, w = obs[k].numpy(), np.asarray(jobs[k])
        assert g.dtype == w.dtype, where + k
        np.testing.assert_array_equal(g, w, err_msg=where + k)
    assert reward.dtype == torch.float32
    np.testing.assert_array_equal(reward.numpy().view(np.int32),
                                  np.asarray(jreward).view(np.int32), err_msg=where)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm), err_msg=where)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc), err_msg=where)


def _assert_planes_equal(fs: dict, jfs: dict, lanes: int, where: str) -> None:
    got = fused_state_to_numpy(fs, lanes)
    assert set(got) == set(jfs)
    for k, g in got.items():
        w = np.asarray(jfs[k])
        assert g.dtype == w.dtype, where + k
        np.testing.assert_array_equal(g, w, err_msg=where + k)


@pytest.mark.parametrize("env_id,max_steps", [
    ("MiniGrid-DoorKey-8x8-v0", 14), ("MiniGrid-Empty-8x8-v0", 11),
    ("MiniGrid-Empty-5x5-v0", 6), ("MiniGrid-Empty-Random-6x6-v0", 8)])
def test_fused_vector_env_matches_jax_through_auto_resets(env_id, max_steps):
    """Every lane, every step, past several auto-resets per lane."""
    n, steps = 16, 36
    jfv = JFusedVectorEnv(minigrid_tpu.make(env_id, max_steps=max_steps), n, block=n)
    fv = FusedVectorEnv(minigrid_tpu_torch.make(env_id, max_steps=max_steps), n,
                        device="cpu")
    jobs, jfs = jfv.reset(jax.random.PRNGKey(11))
    obs, fs = fv.reset(rng.PRNGKey(11, CPU))
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(obs[k].numpy(), np.asarray(jobs[k]))
    _assert_planes_equal(fs, jfs, jfv._lanes, "reset: ")
    r = np.random.default_rng(3)
    weights = np.full(8, 0.6 / 7)
    weights[2] = 0.4  # forward-heavy, so that agents reach the goal
    ends = goals = 0
    for t in range(steps):
        a = r.choice(8, n, p=weights).astype(np.int32)
        want = jfv.step(jfs, jnp.asarray(a))
        got = fv.step(fs, torch.from_numpy(a))
        _assert_fused_step_equal(got, want, f"step {t}: ")
        fs, jfs = got[1], want[1]
        _assert_planes_equal(fs, jfs, jfv._lanes, f"step {t}: ")
        ends += int((got[3] | got[4]).sum())
        goals += int((got[2] > 0).sum())
    assert ends >= 2 * n, ends
    if env_id in ("MiniGrid-Empty-5x5-v0", "MiniGrid-Empty-Random-6x6-v0"):
        assert goals > 0, goals  # the reward's fma path ran


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Empty-8x8-v0"])
def test_fused_lockstep_parity(env_id):
    """The mirror of the JAX package's test: the fused step against the
    port's ``VectorEnv(auto_reset=False)`` on the same state and actions,
    obs bitwise on live lanes, reward with allclose (the two round the goal
    reward differently), flags exactly, until every lane has ended once."""
    env = minigrid_tpu_torch.make(env_id)
    n = 8
    fv = FusedVectorEnv(env, n, device="cpu")
    xv = minigrid_tpu_torch.VectorEnv(env, n, auto_reset=False, device="cpu")
    key = rng.PRNGKey(0, CPU)
    fobs, fs = fv.reset(key)
    xobs, xs = xv.reset(key)
    assert torch.equal(fobs["image"], xobs["image"])
    r = np.random.default_rng(0)
    alive = np.ones(n, bool)
    for _ in range(80):
        a = torch.from_numpy(r.integers(0, 8, n).astype(np.int32))
        fobs, fs, fr, fte, ftr, _ = fv.step(fs, a)
        xobs, xs, xr, xte, xtr, _ = xv.step(xs, a)
        done_now = (xte | xtr).numpy()
        live = alive & ~done_now
        np.testing.assert_array_equal(fobs["image"].numpy()[live],
                                      xobs["image"].numpy()[live])
        assert np.allclose(fr.numpy()[alive], xr.numpy()[alive])
        assert np.array_equal(fte.numpy()[alive], xte.numpy()[alive])
        assert np.array_equal(ftr.numpy()[alive], xtr.numpy()[alive])
        alive &= ~done_now
        if not alive.any():
            break


def test_fused_regeneration_layouts_valid():
    """Auto-reset inside the step produces structurally valid DoorKey levels
    and zeroed step counters."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", max_steps=10)
    n = 8
    fv = FusedVectorEnv(env, n, device="cpu")
    _, fs = fv.reset(rng.PRNGKey(0, CPU))
    for _ in range(12):
        _, fs, _, _, _, _ = fv.step(fs, torch.full((n,), 6, dtype=torch.int32))
    states = fv.to_env_states(fs)
    typ = (states.grid & 0xFF).numpy()
    T = C.OBJECT_TO_IDX
    for i in range(n):
        g = typ[i]
        assert (g[:, 0] == T["wall"]).all()
        assert g[6, 6] == T["goal"]
        assert (g == T["door"]).sum() == 1
        assert (g == T["key"]).sum() == 1
        assert int(states.step_count[i]) <= 2


def test_to_env_states_matches_jax():
    env_id = "MiniGrid-DoorKey-6x6-v0"
    jfv = JFusedVectorEnv(minigrid_tpu.make(env_id), 8, block=8)
    fv = FusedVectorEnv(minigrid_tpu_torch.make(env_id), 8, device="cpu")
    _, jfs = jfv.reset(jax.random.PRNGKey(4))
    _, fs = fv.reset(rng.PRNGKey(4, CPU))
    a = np.array([3, 2, 5, 0, 1, 3, 4, 2], dtype=np.int32)
    for _ in range(3):
        _, jfs, *_ = jfv.step(jfs, jnp.asarray(a))
        _, fs, *_ = fv.step(fs, torch.from_numpy(a))
    assert_state_equal(fv.to_env_states(fs), jfv.to_env_states(jfs))


def test_fused_step_leaves_its_state_valid():
    """``step`` updates nothing in place: stepping the same ``fs`` twice
    gives the same result, and ``fs`` is unchanged."""
    fv = FusedVectorEnv(minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0", max_steps=3),
                        6, device="cpu")
    _, fs = fv.reset(rng.PRNGKey(9, CPU))
    before = {k: v.clone() for k, v in fs.items()}
    a = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    first = fv.step(fs, a)
    second = fv.step(fs, a)
    for k in before:
        assert torch.equal(fs[k], before[k]), k
        assert torch.equal(first[1][k], second[1][k]), k
    assert torch.equal(first[0]["image"], second[0]["image"])
    assert int(first[1]["t"]) == 1


def test_fused_unsupported_env_raises():
    class FourRoomsEnv(Env):  # no fused generator
        pass

    with pytest.raises(NotImplementedError):
        FusedVectorEnv(FourRoomsEnv(grid_size=19), 8, device="cpu")


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-6x6-v0", "MiniGrid-DoorKey-5x5-v0"])
def test_vector_env_without_auto_reset_matches_jax(env_id):
    """``auto_reset=False`` returns the stepped states as they are, for the
    default and the pooled strategy (which then keeps no ring)."""
    from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

    n = 8
    for strategy in (None, "pooled"):
        jv = JVectorEnv(minigrid_tpu.make(env_id, max_steps=5), n, auto_reset=False,
                        reset_strategy=strategy, pool_refill=4)
        v = minigrid_tpu_torch.make_vec(env_id, n, auto_reset=False,
                                        reset_strategy=strategy, pool_refill=4,
                                        device="cpu", max_steps=5)
        _, jst = jv.reset(jax.random.PRNGKey(2))
        _, st = v.reset(rng.PRNGKey(2, CPU))
        r = np.random.default_rng(1)
        for _ in range(7):
            a = r.integers(0, 8, n).astype(np.int32)
            jo, jst, jr, jte, jtr, _ = jv.step(jst, jnp.asarray(a))
            o, st, rew, te, tr, _ = v.step(st, torch.from_numpy(a))
            np.testing.assert_array_equal(o["image"].numpy(), np.asarray(jo["image"]))
            np.testing.assert_array_equal(rew.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
        assert_state_equal(st, jst)
        assert bool(tr.all())  # past max_steps and never reset
