"""The port's 15 wrappers against the JAX package's, on the same states.

Every wrapper's observation is held against ``jax.vmap(wrapper.observation)``
of the JAX wrapper on the same states, bitwise (the ``"angle"`` direction
within ``ANGLE_ULP``: XLA's ``arctan`` and torch's differ in the last bits).
The DoorKey states are ``test_torch_render.walked_fields``' with three more
edits: an orange ball in front of one agent and an orange ball in another's
hands (the one-hot's 10 color classes leave orange a zero row), and one grid
without its goal (EasyMode and NoLanguage then read (-1, -1)).  The
mission-tokenizing wrappers also run on Fetch (a table of many codes, some
outside the vocabulary) and on a BabyAI level (one representative code), the
BabyAI states from the port's generator.  All JAX observations of one batch
come from one compiled program.

Then the engine's refusals, in both packages: a bonus wrapper over a pooled
BabyAI level with the best-effort refill fails at its first step (the JAX
refill receives the level's bare ``EnvState``), while the strict refill and
the conditional strategy run; ``FusedVectorEnv`` refuses a wrapper.  Last, the
two timing tools run on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
import minigrid_tpu.wrappers as JW
from minigrid_tpu.ops.fused_step import FusedVectorEnv as JFusedVectorEnv
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

import minigrid_tpu_torch
import minigrid_tpu_torch.wrappers as W
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.state import map_fields
from minigrid_tpu_torch.parallel.vector import PooledState, VectorEnv
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.test_torch_babyai_step import babyai_jax_state
from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_render import DOORKEY, jax_program, walked_fields
from tests.test_torch_zoo_step import _jax_state
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
ANGLE_ULP = 2
FETCH = "MiniGrid-Fetch-8x8-N3-v0"
BABYAI = "BabyAI-GoToRedBallGrey-v0"
_ORANGE_BALL = (C.OBJECT_TO_IDX["ball"], C.COLOR_TO_IDX["orange"], 0)


def _pack(triple) -> int:
    return triple[0] | triple[1] << 8 | triple[2] << 16


def doorkey_fields() -> dict:
    f = walked_fields()
    # env 2: an orange ball on the cell in front of the agent
    (x, y), d = f["agent_pos"][2], f["agent_dir"][2]
    dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1)][d]
    f["grid"][2, x + dx, y + dy] = _pack(_ORANGE_BALL)
    # env 3: an orange ball in the agent's hands
    f["carrying"][3] = _ORANGE_BALL
    # env 4: no goal
    g = f["grid"][4]
    g[(g & 0xFF) == C.OBJECT_TO_IDX["goal"]] = _pack(C.EMPTY_TRIPLE)
    return f


# name -> (make(wrappers module, env) -> wrapper); each built in both packages
DOORKEY_WRAPPERS = {
    "ImgObs": lambda M, e: M.ImgObsWrapper(e),
    "OneHotPartialObs": lambda M, e: M.OneHotPartialObsWrapper(e),
    "FullyObs": lambda M, e: M.FullyObsWrapper(e),
    "SymbolicObs": lambda M, e: M.SymbolicObsWrapper(e),
    "RGBImgObs": lambda M, e: M.RGBImgObsWrapper(e),
    "RGBImgPartialObs": lambda M, e: M.RGBImgPartialObsWrapper(e),
    "ViewSize3": lambda M, e: M.ViewSizeWrapper(e, 3),
    "ViewSize5": lambda M, e: M.ViewSizeWrapper(e, 5),
    "ViewSize9": lambda M, e: M.ViewSizeWrapper(e, 9),
    "ViewSize11": lambda M, e: M.ViewSizeWrapper(e, 11),
    "DirectionSlope": lambda M, e: M.DirectionObsWrapper(e),
    "DirectionAngle": lambda M, e: M.DirectionObsWrapper(e, type="angle"),
    "DictObservationSpace": lambda M, e: M.DictObservationSpaceWrapper(e),
    "FlatObs": lambda M, e: M.FlatObsWrapper(e),
    "EasyMode": lambda M, e: M.EasyModeWrapper(e),
    "NoLanguage": lambda M, e: M.NoLanguageWrapper(e),
    "ActionBonus": lambda M, e: M.ActionBonus(e),
    "StateBonus": lambda M, e: M.StateBonus(e),
    "Reseed": lambda M, e: M.ReseedWrapper(e, seeds=[3, 4]),
}
# the batched path of RGBImgPartialObsWrapper, in both layouts
BATCHED = {
    "RGBImgPartialObs.batch_hwc": lambda M, e: M.RGBImgPartialObsWrapper(e),
    "RGBImgPartialObs.batch_chw": lambda M, e: M.RGBImgPartialObsWrapper(
        e, channels_first=True),
}
MISSION_WRAPPERS = {
    "DictObservationSpace": DOORKEY_WRAPPERS["DictObservationSpace"],
    "FlatObs": DOORKEY_WRAPPERS["FlatObs"],
}


def _bonus(name: str, st, js, counts_shape: tuple):
    """A bonus wrapper's observation reads a ``BonusState``."""
    if name not in ("ActionBonus", "StateBonus"):
        return st, js
    counts = np.arange(int(np.prod(counts_shape)), dtype=np.int32).reshape(counts_shape)
    return (W.BonusState(inner=st, counts=torch.from_numpy(counts)),
            JW.BonusState(inner=js, counts=jnp.asarray(counts)))


def _observe(env_id: str, to_jax, fields: dict, table: dict, batched: dict):
    """{name: (port observation, JAX observation)} for every wrapper of
    ``table`` (``batched``: through ``observation_batch``) on ``fields``;
    the JAX side in one compiled program."""
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    p, jp = env.default_params, jenv.default_params
    st, js = state_from_numpy(fields, CPU), to_jax(fields)
    b = fields["agent_dir"].shape[0]
    ports, jaxes, states = {}, {}, {}
    for name, make in {**table, **batched}.items():
        ports[name], jaxes[name] = make(W, env), make(JW, jenv)
        shape = ((b, p.width, p.height, 4, 8) if name == "ActionBonus"
                 else (b, p.width, p.height))
        states[name] = _bonus(name, st, js, shape)

    def run_jax(jstates):
        # the observation wrappers' transforms read one traced base
        # observation: ``observation`` is ``transform(env.observation(s), s)``
        base = jax.vmap(lambda s: jenv.observation(s, jp))(jstates["_base"])
        out = {}
        for name, w in jaxes.items():
            s = jstates[name]
            if name in batched:
                out[name] = w.observation_batch(s, jp)
            elif isinstance(w, JW.ObservationWrapper):
                out[name] = jax.vmap(lambda o, s, w=w: w.transform(o, s, jp))(base, s)
            else:
                out[name] = jax.vmap(lambda s, w=w: w.observation(s, jp))(s)
        return out

    jstates = {k: v[1] for k, v in states.items()}
    jstates["_base"] = js
    want = jax_program(run_jax, jstates)(jstates)
    return {name: ((ports[name].observation_batch if name in batched
                    else ports[name].observation)(states[name][0], p), want[name])
            for name in ports}


@pytest.fixture(scope="module")
def doorkey_obs():
    return _observe(DOORKEY, _jax_state, doorkey_fields(), DOORKEY_WRAPPERS, BATCHED)


def _babyai_fields(n: int = 8) -> dict:
    env = minigrid_tpu_torch.make(BABYAI)
    keys = rng.split(rng.PRNGKey(5, CPU), n)
    return state_to_numpy(env.generate(keys, env.default_params, CPU))


@pytest.fixture(scope="module")
def mission_obs():
    """Dict and Flat over Fetch (many codes) and over a BabyAI level."""
    env = minigrid_tpu_torch.make(FETCH)
    fetch = state_to_numpy(env.generate(rng.split(rng.PRNGKey(6, CPU), 32),
                                        env.default_params, CPU))
    return {FETCH: _observe(FETCH, _jax_state, fetch, MISSION_WRAPPERS, {}),
            BABYAI: _observe(BABYAI, babyai_jax_state, _babyai_fields(),
                             MISSION_WRAPPERS, {})}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix, tree


def assert_obs_equal(got, want, where: str, ulp: dict | None = None) -> None:
    """Same keys, shapes, dtypes and values (nan equal); leaves named in
    ``ulp`` within that many float32 ulps."""
    g_leaves, w_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert set(g_leaves) == set(w_leaves), (where, set(g_leaves), set(w_leaves))
    for k, g in g_leaves.items():
        g, w = g.cpu().numpy(), np.asarray(w_leaves[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k, g.dtype, w.dtype)
        tol = (ulp or {}).get(k)
        if tol is None:
            np.testing.assert_array_equal(g, w, err_msg=where + k)
            continue
        same_nan = np.isnan(g) == np.isnan(w)
        assert same_nan.all(), where + k
        diff = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
        assert diff[~np.isnan(g)].max(initial=0) <= tol, (where, k, diff.max())


def test_every_jax_wrapper_name_exists_in_the_port():
    assert set(JW.__all__) <= set(W.__all__)
    for name in JW.__all__:
        assert hasattr(W, name), name
    assert len([n for n in W.__all__ if n.endswith(("Wrapper", "Bonus"))]) == 17


@pytest.mark.parametrize("name", list(DOORKEY_WRAPPERS) + list(BATCHED))
def test_wrapper_observation_matches_jax(doorkey_obs, name):
    got, want = doorkey_obs[name]
    ulp = {"goal_direction.": ANGLE_ULP} if name == "DirectionAngle" else None
    assert_obs_equal(got, want, f"{name}: ", ulp)


def test_one_hot_leaves_orange_a_zero_row(doorkey_obs):
    got, _ = doorkey_obs["OneHotPartialObs"]
    img = got["image"]
    assert img.shape == (16, 7, 7, 47) and img.dtype == torch.uint8
    # env 2: the orange ball straight ahead; env 3: carried (V//2, V-1)
    for env, (i, j) in ((2, (3, 5)), (3, (3, 6))):
        cell = img[env, i, j]
        assert cell[C.OBJECT_TO_IDX["ball"]] == 1
        assert cell[34:44].sum() == 0  # no color class
        assert cell[44:].sum() == 1


def test_no_goal_reads_minus_one(doorkey_obs):
    for name in ("EasyMode", "NoLanguage"):
        got, _ = doorkey_obs[name]
        assert got["target_cell"][4].tolist() == [-1, -1]
        assert (got["target_cell"][5] >= 0).all()
    # DirectionObsWrapper reads the missing goal as (0, 0), as JAX's does
    got, _ = doorkey_obs["DirectionSlope"]
    assert got["goal_direction"].dtype == torch.float32


@pytest.mark.parametrize("env_id", [FETCH, BABYAI])
@pytest.mark.parametrize("name", list(MISSION_WRAPPERS))
def test_mission_wrappers_match_jax(mission_obs, env_id, name):
    got, want = mission_obs[env_id][name]
    assert_obs_equal(got, want, f"{env_id} {name}: ")


def test_mission_tables_match_jax():
    """The port's mission codes and token rows are JAX's; a BabyAI level
    has one representative code, so every BabyAI mission maps to row 0."""
    for env_id in (FETCH, BABYAI, DOORKEY):
        env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
        np.testing.assert_array_equal(env.mission_codes(), jenv.mission_codes())
        d, jd = W.DictObservationSpaceWrapper(env), JW.DictObservationSpaceWrapper(jenv)
        np.testing.assert_array_equal(d._table._np["rows"], np.asarray(jd._tokens))
        fl, jfl = W.FlatObsWrapper(env), JW.FlatObsWrapper(jenv)
        np.testing.assert_array_equal(fl._table._np["rows"], np.asarray(jfl._strs))
    babyai = minigrid_tpu_torch.make(BABYAI)
    assert babyai.mission_codes().shape == (1, 43)
    # out-of-vocabulary Fetch missions (colors past the six) are zero rows
    rows = W.DictObservationSpaceWrapper(minigrid_tpu_torch.make(FETCH))._table._np["rows"]
    assert (rows.sum(axis=1) == 0).any() and (rows.sum(axis=1) > 0).any()


def test_reseed_wrapper_cycles_its_seeds():
    env = minigrid_tpu_torch.make(DOORKEY)
    wrapped = W.ReseedWrapper(env, seeds=[11, 22])
    grids = [wrapped.reset(device=CPU)[1].grid for _ in range(4)]
    assert grids[0].shape == (1, 8, 8)
    assert torch.equal(grids[0], grids[2]) and torch.equal(grids[1], grids[3])
    assert not torch.equal(grids[0], grids[1])
    want = env.generate(rng.PRNGKey(11, CPU)[None], env.default_params, CPU).grid
    assert torch.equal(grids[0], want)
    assert wrapped.seed_idx == 0


def test_bonus_state_crosses_the_bridge_and_nests_in_map_fields():
    env = W.ActionBonus(minigrid_tpu_torch.make(DOORKEY))
    st = env.generate(rng.split(rng.PRNGKey(1, CPU), 4), env.default_params, CPU)
    assert isinstance(st, W.BonusState) and st.counts.shape == (4, 8, 8, 4, 8)
    f = state_to_numpy(st)
    assert set(f) == {"inner", "counts"} and f["counts"].dtype == np.int32
    back = state_from_numpy(f, CPU)
    assert isinstance(back, W.BonusState)
    assert_state_equal(back, JW.BonusState(inner=_jax_state(f["inner"]),
                                           counts=jnp.asarray(f["counts"])))
    half = map_fields(lambda x: x[:2], st)
    assert isinstance(half, W.BonusState) and half.inner.grid.shape[0] == 2
    assert torch.equal(half.rng, st.rng[:2])
    with pytest.raises(TypeError):
        map_fields(lambda x, y: x, st, st.inner)


def _bonus_babyai_jax(fields: dict):
    """numpy fields of a pooled ``BonusState`` ring -> the JAX state."""
    from minigrid_tpu.parallel.vector import PooledState as JPooledState

    def bonus(f):
        return JW.BonusState(inner=babyai_jax_state(f["inner"]),
                             counts=jnp.asarray(f["counts"]))

    if "envs" in fields:
        rest = {k: jnp.asarray(v) for k, v in fields.items() if k not in ("envs", "pool")}
        return JPooledState(envs=bonus(fields["envs"]), pool=bonus(fields["pool"]), **rest)
    return bonus(fields)


def test_bonus_over_pooled_babyai_best_effort_raises_in_both_packages():
    """The wrapper hands the refill the level's ``generate_attempt``, whose
    bare ``EnvState`` cannot fill a ring of ``BonusState``: JAX fails to
    trace the step, the port raises at its first refill and names why."""
    b = 64
    venv = VectorEnv(W.ActionBonus(minigrid_tpu_torch.make(BABYAI)), b, device=CPU)
    jvenv = JVectorEnv(JW.ActionBonus(minigrid_tpu.make(BABYAI)), b)
    assert (venv.reset_strategy, venv.best_effort_refill) == ("pooled", True)
    assert (jvenv.reset_strategy, jvenv.best_effort_refill) == ("pooled", True)
    _, st = venv.reset(rng.PRNGKey(2, CPU))
    assert isinstance(st.envs, W.BonusState) and isinstance(st.pool, W.BonusState)
    a = np.zeros(b, np.int32)
    with pytest.raises(ValueError, match="generate_attempt.*strict_refill"):
        venv.step(st, torch.from_numpy(a))
    with pytest.raises(ValueError, match="dataclass"):
        jvenv.step(_bonus_babyai_jax(state_to_numpy(st)), jnp.asarray(a))


@pytest.mark.parametrize("kwargs", [{"reset_strategy": "pooled", "strict_refill": True},
                                    {"reset_strategy": "conditional"}])
def test_bonus_over_babyai_runs_strict_and_conditional(kwargs):
    """Both packages build the step (JAX traces it); the port runs 6 steps
    of 2-step episodes, the counts zeroed at each auto-reset."""
    b = 16
    env = W.ActionBonus(minigrid_tpu_torch.make(BABYAI, max_steps=2))
    venv = VectorEnv(env, b, device=CPU, **kwargs)
    jvenv = JVectorEnv(JW.ActionBonus(minigrid_tpu.make(BABYAI, max_steps=2)), b,
                       **kwargs)
    assert not venv.best_effort_refill and not jvenv.best_effort_refill
    _, st = venv.reset(rng.PRNGKey(3, CPU))
    a = np.full(b, 6, np.int32)  # done: the agent stays, one (cell, action) counted
    jvenv._step.lower(_bonus_babyai_jax(state_to_numpy(st)), jnp.asarray(a))
    for t in range(6):
        _, st, r, te, tr, _ = venv.step(st, torch.from_numpy(a))
        envs = st.envs if isinstance(st, PooledState) else st
        # 2-step episodes: every env restarts after its second step
        assert bool((te | tr).all()) == (t % 2 == 1)
        assert int(envs.counts.sum()) == b * ((t + 1) % 2)
        np.testing.assert_array_equal(r.numpy(), np.float32(1.0 / np.sqrt(t % 2 + 1)))


def test_fused_vector_env_refuses_a_wrapper():
    with pytest.raises(NotImplementedError):
        minigrid_tpu_torch.FusedVectorEnv(
            W.ActionBonus(minigrid_tpu_torch.make(DOORKEY)), 4, device=CPU)
    with pytest.raises(NotImplementedError):
        JFusedVectorEnv(JW.ActionBonus(minigrid_tpu.make(DOORKEY)), 256)


def test_wrapper_delegates_the_reset_strategy():
    """The engine reads the wrapped family's attributes, as JAX's does."""
    for env_id, b in (("MiniGrid-MultiRoom-N6-v0", 64), (BABYAI, 64), (DOORKEY, 16)):
        venv = VectorEnv(W.ImgObsWrapper(minigrid_tpu_torch.make(env_id)), b, device=CPU)
        jvenv = JVectorEnv(JW.ImgObsWrapper(minigrid_tpu.make(env_id)), b)
        assert (venv.reset_strategy, venv.pool_refill, venv.best_effort_refill) == (
            jvenv.reset_strategy, jvenv.pool_refill, jvenv.best_effort_refill), env_id


def test_benchmark_runs_on_the_cpu():
    from minigrid_tpu_torch.tools import benchmark

    out = benchmark.benchmark("MiniGrid-LavaGapS7-v0", num_resets=2, num_frames=2,
                              tile_size=8, num_envs=8, vector_steps=4, device="cpu")
    assert set(out) == {"reset_ms", "render_fps", "rgb_partial_step_fps",
                        "vector_env_steps_per_sec"}
    assert all(v > 0 for v in out.values())


def test_battery_prints_a_row_for_rgb_chw(capsys):
    import json

    from minigrid_tpu_torch.tools import battery

    row = battery.run_spec("MiniGrid-DoorKey-8x8-v0:obs=rgb_chw,num_envs=8,steps=4,"
                           "device=cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == row
    assert (row["obs"], row["strategy"], row["steps"], row["num_envs"]) == (
        "rgb_chw", "fused", 4, 8)
    assert row["gather_impl"].startswith("plain") and row["steps_per_sec"] > 0
    assert not battery.device_kernel_gate(device="cpu")


def test_timed_rollout_pooled_counts_served_levels():
    from minigrid_tpu_torch.tools.benchmark import timed_rollout

    venv = minigrid_tpu_torch.make_vec("MiniGrid-Empty-5x5-v0", 64, device=CPU,
                                       reset_strategy="pooled", pool_refill=16,
                                       max_steps=2)
    sps, first_s, stats = timed_rollout(venv, 8, refill_period=4, with_stats=True)
    assert sps > 0 and first_s > 0
    assert stats["resets"] >= 3 * 64 and 0 < stats["fresh_frac"] <= 1
    with pytest.raises(ValueError):
        timed_rollout(venv, 6, refill_period=4)
