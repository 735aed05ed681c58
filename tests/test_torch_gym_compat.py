"""The port's Gymnasium adapter (``gym_compat.py``) against the JAX
package's, and the reference converters of ``utils/convert.py``.

The protocol tests mirror ``tests/test_gym_compat.py`` and hold every output
against JAX's ``GymEnv`` on the same seeds and actions: observations,
mission strings, rewards as float32 bits, flags and ``hash`` (the JAX
adapter's digest of its unbatched state, byte for byte), with and without
``exact_seed``.  ``from_reference``/``state_equals_reference`` run on a
duck-typed stub of a reference env (its ``grid``, ``agent_pos``,
``agent_dir``, ``carrying``, ``step_count``), against JAX's on the same
stub; the checks against the reference itself skip without it, as JAX's
do.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

import minigrid_tpu.gym_compat as jgc
from minigrid_tpu.utils import convert as jconvert

from minigrid_tpu_torch import gym_compat as gc
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.utils import convert
from minigrid_tpu_torch.utils.convert import state_to_numpy

from tests.conftest import requires_reference
from tests.test_torch_bridge import _assert_fields, jax_to_numpy
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_exact_minigrid import row0

CPU = torch.device("cpu")


def pair(env_id: str, **kwargs):
    return jgc.GymEnv(env_id, **kwargs), gc.GymEnv(env_id, device=CPU, **kwargs)


def assert_obs_equal(got: dict, want: dict, where: str = "") -> None:
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), (where, k, type(g), type(w))
        if k == "mission":
            assert g == w, (where, g, w)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


def assert_step_equal(got: tuple, want: tuple, where: str) -> None:
    assert_obs_equal(got[0], want[0], where)
    assert type(got[1]) is float, where
    assert np.float32(got[1]).tobytes() == np.float32(want[1]).tobytes(), (where, got[1], want[1])
    assert got[2:] == want[2:], where


def lockstep(jenv, env, seed: int, steps: int, reset_on_done: bool = True) -> None:
    """Reset both on ``seed`` and step them on the same numpy-seeded actions,
    re-resetting (unseeded) after an episode ends; every output and the
    hash equal."""
    jo, _ = jenv.reset(seed=seed)
    o, _ = env.reset(seed=seed)
    assert_obs_equal(o, jo, f"reset {seed}")
    assert env.hash() == jenv.hash()
    actions = np.random.default_rng(seed).integers(0, env.action_space.n, steps)
    for t, a in enumerate(actions):
        want, got = jenv.step(int(a)), env.step(int(a))
        assert_step_equal(got, want, f"seed {seed} step {t}")
        assert env.hash() == jenv.hash(), t
        if reset_on_done and (want[2] or want[3]):
            jo, _ = jenv.reset()
            o, _ = env.reset()
            assert_obs_equal(o, jo, f"reset after step {t}")


def test_reset_step_protocol():
    jenv, env = pair("MiniGrid-Empty-5x5-v0")
    obs, info = env.reset(seed=0)
    assert set(obs) == {"image", "direction", "mission"} and info == {}
    assert obs["image"].shape == (7, 7, 3) and obs["image"].dtype == np.uint8
    assert isinstance(obs["mission"], str) and isinstance(obs["direction"], np.int64)
    assert env.observation_space.contains(obs)
    assert_obs_equal(obs, jenv.reset(seed=0)[0])
    obs, reward, term, trunc, info = env.step(2)
    assert isinstance(reward, float) and isinstance(term, bool)
    assert isinstance(trunc, bool) and isinstance(info, dict)
    assert_step_equal((obs, reward, term, trunc, info), jenv.step(2), "step")


def test_seed_determinism_and_hash_match_jax():
    env1 = gc.GymEnv("MiniGrid-DoorKey-5x5-v0", device=CPU)
    env2 = gc.GymEnv("MiniGrid-DoorKey-5x5-v0", device=CPU)
    jenv = jgc.GymEnv("MiniGrid-DoorKey-5x5-v0")
    o1, o2, jo = env1.reset(seed=42)[0], env2.reset(seed=42)[0], jenv.reset(seed=42)[0]
    assert_obs_equal(o1, o2)
    assert_obs_equal(o1, jo)
    for a in [0, 2, 1, 2, 5, 3, 2]:
        s1, s2, sj = env1.step(a), env2.step(a), jenv.step(a)
        assert_step_equal(s1, s2, "two ports")
        assert_step_equal(s1, sj, "port vs JAX")
        assert env1.hash() == env2.hash() == jenv.hash()
        assert env1.hash(64) == jenv.hash(64)


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToLocal-v0"])
def test_random_seeds_match_jax(env_id):
    """The key stream of the non-exact reset: PRNGKey(seed), then one split
    a reset, seeded or not."""
    jenv, env = pair(env_id)
    lockstep(jenv, env, seed=5, steps=48)


def test_truncates_at_max_steps():
    jenv, env = pair("MiniGrid-Empty-5x5-v0")
    env.reset(seed=1)
    jenv.reset(seed=1)
    for _ in range(env.max_steps):
        got, want = env.step(6), jenv.step(6)  # done: a no-op
    assert_step_equal(got, want, "last step")
    assert got[3] and not got[2]
    assert env.steps_remaining == 0


def test_render_rgb_matches_jax():
    jenv, env = pair("MiniGrid-Empty-5x5-v0", render_mode="rgb_array")
    env.reset(seed=0)
    jenv.reset(seed=0)
    frame = env.render()
    assert frame.shape == (160, 160, 3) and frame.dtype == np.uint8
    # JAX's render, jitted (eager, it compiles op by op)
    import jax

    want = jax.jit(lambda s: jenv.fenv.get_frame(s, jenv.params, highlight=True))(jenv._state)
    np.testing.assert_array_equal(frame, np.asarray(want))


def test_pickle_round_trip():
    env = gc.GymEnv("BabyAI-GoToLocal-v0", device=CPU)
    env.reset(seed=3)
    env.step(2)
    clone = pickle.loads(pickle.dumps(env))
    assert clone.device == CPU and clone._state.grid.device == CPU
    assert env.hash() == clone.hash()
    _assert_fields(state_to_numpy(clone._state), state_to_numpy(env._state), "clone ")
    for a in (2, 1, 2, 0):
        assert_step_equal(clone.step(a), env.step(a), f"after pickle, action {a}")
    assert env.hash() == clone.hash()
    o1, o2 = env.reset()[0], clone.reset()[0]  # the key stream survives too
    assert_obs_equal(o1, o2)


def test_gym_make_under_the_ports_namespace():
    gym = pytest.importorskip("gymnasium")
    n = gc.register_gym_envs()
    assert n == len(gc.registered_ids()) or n == 0  # 0 when registered already
    assert gc.register_gym_envs() == 0
    spec = gym.spec("minigrid_tpu_torch/MiniGrid-FourRooms-v0")
    assert isinstance(spec.entry_point, gc._Entry)
    env = gym.make("minigrid_tpu_torch/MiniGrid-FourRooms-v0", device="cpu")
    obs, _ = env.reset(seed=0)
    assert obs["image"].shape == (7, 7, 3)
    env.step(env.action_space.sample())
    env.close()
    exact = gym.make("minigrid_tpu_torch/MiniGrid-DoorKey-8x8-v0", exact_seed=True,
                     device="cpu")
    jexact = jgc.GymEnv("MiniGrid-DoorKey-8x8-v0", exact_seed=True)
    assert_obs_equal(exact.reset(seed=4)[0], jexact.reset(seed=4)[0])
    assert exact.unwrapped.hash() == jexact.hash()
    assert pickle.loads(pickle.dumps(exact.spec)).id == exact.spec.id


def test_view_geometry_and_agent_sees_match_jax():
    jenv, env = pair("MiniGrid-DoorKey-8x8-v0")
    env.reset(seed=0)
    jenv.reset(seed=0)
    rng = np.random.default_rng(0)
    for t in range(16):
        a = int(rng.integers(0, 7))
        env.step(a)
        jenv.step(a)
        assert env.agent_pos == jenv.agent_pos and env.agent_dir == jenv.agent_dir, t
        np.testing.assert_array_equal(env.front_pos, jenv.front_pos)
        np.testing.assert_array_equal(env.right_vec, jenv.right_vec)
        np.testing.assert_array_equal(env.carrying, jenv.carrying)
        np.testing.assert_array_equal(env.grid, jenv.grid)
        assert env.steps_remaining == jenv.steps_remaining
        for x in range(8):
            for y in range(8):
                assert env.relative_coords(x, y) == jenv.relative_coords(x, y), (t, x, y)
                assert env.in_view(x, y) == jenv.in_view(x, y), (t, x, y)
                assert env.agent_sees(x, y) == jenv.agent_sees(x, y), (t, x, y)
        assert str(env) == str(jenv), t


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-MultiRoom-N4-S5-v0",
                                    "MiniGrid-ObstructedMaze-1Dlhb-v0", "BabyAI-GoToLocal-v0"])
def test_exact_seed_matches_jax(env_id):
    jenv, env = pair(env_id, exact_seed=True)
    for seed in (0, 5):
        lockstep(jenv, env, seed=seed, steps=24, reset_on_done=False)
    assert str(env) == str(jenv)


def test_mission_spaces_match_jax():
    for env_id in ("MiniGrid-Fetch-8x8-N3-v0", "MiniGrid-PutNear-6x6-N2-v0"):
        jenv, env = pair(env_id)
        space, jspace = env.observation_space["mission"], jenv.observation_space["mission"]
        assert isinstance(space, gc._EnumMissionSpace)
        assert space._strings == jspace._strings
        assert space.contains(space.sample()) and not space.contains("go home")
    env = gc.GymEnv("BabyAI-BossLevel-v0", device=CPU)
    obs, _ = env.reset(seed=0)
    assert env.observation_space["mission"].contains(obs["mission"])
    assert isinstance(pickle.loads(pickle.dumps(env.observation_space["mission"])).sample(),
                      str)


def test_human_render_opens_a_window():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from minigrid_tpu_torch.utils.window import Window

    env = gc.GymEnv("MiniGrid-Empty-5x5-v0", render_mode="human", device=CPU)
    env.reset(seed=0)
    env.step(2)
    window = env._window
    assert isinstance(window, Window) and not window.closed
    np.testing.assert_array_equal(np.asarray(window.imshow_obj.get_array()),
                                  env.fenv.get_frame(env._state, env.params)[0].numpy())
    window.set_caption("step 1")
    assert window.ax.get_xlabel() == "step 1"
    env.close()
    assert env._window is None and window.closed
    plt.close("all")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gc.GymEnv("MiniGrid-DoorKey-5x5-v0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_reference(_stub())


# -- from_reference on a stub of the reference's object graph ------------------------

class _Obj:
    def __init__(self, kind: str, color: str, state: str | None = None, contains=None):
        self.type, self.color, self.contains = kind, color, contains
        self.state = state

    def encode(self):
        s = C.STATE_TO_IDX[self.state] if self.state else 0
        return (C.OBJECT_TO_IDX[self.type], C.COLOR_TO_IDX[self.color], s)


class _Grid:
    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.cells = {}

    def get(self, i, j):
        return self.cells.get((i, j))

    def encode(self):
        out = np.broadcast_to(np.asarray(C.EMPTY_TRIPLE), (self.width, self.height, 3)).copy()
        for (i, j), obj in self.cells.items():
            out[i, j] = obj.encode()
        return out.astype(np.uint8)


class _Ref:
    def __init__(self, grid, agent_pos, agent_dir, carrying=None, step_count=0):
        self.grid, self.agent_pos, self.agent_dir = grid, agent_pos, agent_dir
        self.carrying, self.step_count = carrying, step_count


def _stub(carry_box: bool = True) -> _Ref:
    g = _Grid(7, 6)
    for i in range(7):
        g.cells[i, 0] = g.cells[i, 5] = _Obj("wall", "grey")
    g.cells[3, 2] = _Obj("door", "yellow", "locked")
    g.cells[4, 3] = _Obj("box", "purple", contains=_Obj("key", "yellow"))
    g.cells[1, 4] = _Obj("ball", "red")
    g.cells[5, 4] = _Obj("box", "green")  # empty box
    carrying = _Obj("box", "blue", contains=_Obj("ball", "grey")) if carry_box else None
    return _Ref(g, (2, 3), 1, carrying, step_count=7)


@pytest.mark.parametrize("carry_box", [True, False])
def test_from_reference_matches_jax(carry_box):
    ref = _stub(carry_box)
    state = convert.from_reference(ref, device=CPU)
    jstate = jconvert.from_reference(ref)
    _assert_fields(row0(state_to_numpy(state)), jax_to_numpy(jstate), "from_reference ")
    assert convert.encode_obj(None).tolist() == jconvert.encode_obj(None).tolist()
    assert convert.state_equals_reference(state, ref)
    assert jconvert.state_equals_reference(jstate, ref)
    ref.agent_dir = 2
    assert not convert.state_equals_reference(state, ref)
    assert not jconvert.state_equals_reference(jstate, ref)
    ref.agent_dir = 1
    ref.grid.cells[1, 4] = _Obj("ball", "blue")
    assert not convert.state_equals_reference(state, ref)
    assert not jconvert.state_equals_reference(jstate, ref)


def test_from_reference_steps_like_jax():
    """A lowered stub steps on in both packages alike."""
    import jax
    import jax.numpy as jnp

    import minigrid_tpu
    import minigrid_tpu_torch

    jenv, env = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0"), minigrid_tpu_torch.make(
        "MiniGrid-DoorKey-8x8-v0")
    g = _Grid(8, 8)
    for i in range(8):
        g.cells[i, 0] = g.cells[i, 7] = g.cells[0, i] = g.cells[7, i] = _Obj("wall", "grey")
    g.cells[6, 6] = _Obj("goal", "green")
    g.cells[2, 3] = _Obj("key", "yellow")
    ref = _Ref(g, (2, 2), 1)
    state, jstate = convert.from_reference(ref, device=CPU), jconvert.from_reference(ref)
    j_step = jax.jit(lambda s, a: jenv.step(s, a, jenv.default_params))
    for a in (3, 0, 0, 2, 2, 1, 2):  # pick up the key below, then walk
        jobs, jstate, *_ = j_step(jstate, jnp.int32(a))
        obs, state, *_ = env.step(state, torch.tensor([a], dtype=torch.int32),
                                  env.default_params)
        np.testing.assert_array_equal(obs["image"][0].numpy(), np.asarray(jobs["image"]))
    _assert_fields(row0(state_to_numpy(state)), jax_to_numpy(jstate), "stepped ")
    assert int(state.carrying[0, 0]) == C.OBJECT_TO_IDX["key"]


# -- against the reference itself (skips without it, as the JAX package's do) ----------

@requires_reference
def test_exact_seed_matches_reference():
    from minigrid.envs import DoorKeyEnv as RefDoorKey

    ref = RefDoorKey(size=8)
    env = gc.GymEnv("MiniGrid-DoorKey-8x8-v0", exact_seed=True, device=CPU)
    for seed in (0, 5):
        obs_ref, _ = ref.reset(seed=seed)
        obs, _ = env.reset(seed=seed)
        np.testing.assert_array_equal(obs_ref["image"], obs["image"])
        rng = np.random.default_rng(seed)
        for _ in range(60):
            a = int(rng.integers(0, 7))
            o_r, r_r, te_r, tr_r, _ = ref.step(a)
            o, r, te, tr, _ = env.step(a)
            np.testing.assert_array_equal(o_r["image"], o["image"])
            assert abs(r_r - r) < 1e-6 and te_r == te and tr_r == tr
            if te or tr:
                break


@requires_reference
def test_from_reference_matches_a_reference_env():
    from minigrid.envs.doorkey import DoorKeyEnv as RefDoorKey

    ref = RefDoorKey(size=8)
    ref.reset(seed=5)
    env = gc.GymEnv("MiniGrid-DoorKey-8x8-v0", device=CPU)
    env.reset(seed=0)
    env._state = convert.from_reference(ref, device=CPU)
    assert convert.state_equals_reference(env._state, ref)
    assert str(env) == str(ref)


def test_to_host_reads_back_every_dtype_in_one_copy():
    r = np.random.default_rng(0)
    ts = [torch.from_numpy(r.integers(0, 255, (2, 3, 3)).astype(np.uint8)),
          torch.tensor(3, dtype=torch.int32),
          torch.from_numpy(r.integers(-5, 5, (7,)).astype(np.int64)),
          torch.tensor([0.1, -2.5e-8, float("inf")], dtype=torch.float32),
          torch.tensor([True, False, True]),
          torch.zeros((0, 4), dtype=torch.int32)]
    got = convert.to_host(ts)
    assert len(got) == len(ts)
    for g, t in zip(got, ts):
        assert g.shape == tuple(t.shape) and g.dtype == t.numpy().dtype
        np.testing.assert_array_equal(g, t.numpy())
