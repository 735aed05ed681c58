"""The port's oracle and demo tools (``tools/oracle.py``,
``tools/generate_demos.py``) against the JAX package's.

Both packages draw the same levels from the same keys, so the demos are
held equal demo for demo: missions, actions, rewards as float32 bits,
targets and every observation bitwise.  The last four tests are the port's
copies of the JAX package's oracle tests (``tests/test_tools.py:17-55``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu.tools import generate_demos as jdemos
from minigrid_tpu.tools import oracle as joracle

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.grid_ops import unpack_np
from minigrid_tpu_torch.tools import generate_demos as demos_mod
from minigrid_tpu_torch.tools import oracle

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
NEGATED = "MiniGrid-Negated-Simple-v0"
CONTRASTIVE = "ContrastiveTrajectoryDataset-v0"


@functools.cache
def jax_demos(env_id: str, num_demos: int, seed: int):
    return jdemos.collect(env_id, num_demos, seed=seed)


@functools.cache
def port_demos(env_id: str, num_demos: int, seed: int):
    return demos_mod.collect(env_id, num_demos, seed=seed, device=CPU)


def negated_pair(seed: int = 0):
    """Negated-Simple at ``seed`` in both packages: (JAX env, state, port env,
    state)."""
    jenv = minigrid_tpu.make(NEGATED)
    _, jstate = jenv.reset(jax.random.PRNGKey(seed), jenv.default_params)
    env = minigrid_tpu_torch.make(NEGATED)
    _, state = env.reset(rng.PRNGKey(seed, CPU)[None], env.default_params, CPU)
    return jenv, jstate, env, state


def assert_demos_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] and g[5] == w[5], i
        assert g[2] == w[2], (i, g[2], w[2])
        assert (np.asarray(g[3], np.float32).tobytes()
                == np.asarray(w[3], np.float32).tobytes()), (i, g[3], w[3])
        assert tuple(int(x) for x in g[4]) == tuple(int(x) for x in w[4]), i
        assert len(g[1]) == len(w[1]) == len(g[2]), i
        for t, (og, ow) in enumerate(zip(g[1], w[1])):
            assert set(og) == set(ow), (i, t)
            for k, v in ow.items():
                v = np.asarray(v)
                assert og[k].dtype == v.dtype and og[k].shape == v.shape, (i, t, k)
                np.testing.assert_array_equal(og[k], v, err_msg=f"demo {i} step {t} {k}")


def test_bfs_matches_jax_on_the_negated_level():
    _, _, env, state = negated_pair(0)
    grid = unpack_np(state.grid[0].numpy())
    target = state.extra["target_cell"][0].tolist()
    start = [(int(state.agent_pos[0, 0]), int(state.agent_pos[0, 1]), 1, 0)]
    accept = lambda i, j: [i, j] == target  # noqa: E731
    got = oracle.breadth_first_search(grid, start, accept)
    want = joracle.breadth_first_search(grid, start, accept)
    assert got[0] is not None and got[:2] == want[:2]
    assert got[2] == want[2]


def test_bfs_matches_jax_on_a_random_walled_grid():
    r = np.random.default_rng(7)
    w, h = 13, 11
    types = np.where(r.random((w, h)) < 0.3, 2, 1)  # walls and empty cells
    types[[0, -1], :] = 2
    types[:, [0, -1]] = 2
    types[4, 5] = 4  # a door, closed below (state 1): it blocks
    grid = np.stack([types, np.zeros_like(types), np.zeros_like(types)], -1).astype(np.uint8)
    grid[4, 5, 2] = 1
    free = [(x, y) for x in range(w) for y in range(h) if types[x, y] == 1]
    found = 0
    for k in range(12):
        (sx, sy), goal = free[k], list(free[-1 - k])
        start = [(sx, sy, 0, 1)]
        accept = lambda i, j, g=goal: [i, j] == g  # noqa: E731
        got = oracle.breadth_first_search(grid, start, accept)
        assert got == joracle.breadth_first_search(grid, start, accept)
        found += got[0] is not None
    assert found > 0


def test_action_sequence_and_next_action_match_jax():
    jenv, jstate, env, state = negated_pair(0)
    jagent = joracle.OracleAgent(jenv)
    agent = oracle.OracleAgent(env, device=CPU)
    target = list(state.extra["target_cell"][0].tolist())
    assert target == np.asarray(jstate.extra["target_cell"]).tolist()
    path = agent.action_sequence(state, target)
    assert path is not None and path == jagent.action_sequence(jstate, target)
    mission = env.mission_text(state.mission[0].numpy())
    assert mission == jenv.mission_text(np.asarray(jstate.mission))
    x, y = path[0]
    for cell in [(x + 1, y), (x, y + 1), (x - 1, y), (x, y - 1)]:  # every turn
        for goal in (False, True):
            for m in (mission, "go to the ball", "pick up the key"):
                assert (agent.next_action(state, cell, goal, m)
                        == jagent.next_action(jstate, cell, goal, m))


@pytest.mark.parametrize("env_id,num_demos,seed,least", [
    (CONTRASTIVE, 6, 0, 5),
    (CONTRASTIVE, 4, 2, 1),
    (NEGATED, 8, 0, 1),
    (NEGATED, 8, 3, 0),  # every seed-3 episode ends without a reward: no demo
])
def test_collect_matches_jax(env_id, num_demos, seed, least):
    got, want = port_demos(env_id, num_demos, seed), jax_demos(env_id, num_demos, seed)
    assert_demos_equal(got, want)
    assert len(got) >= least
    if least == 0:
        assert got == []


def test_pack_demos_matches_jax():
    got = demos_mod.pack_demos(port_demos(CONTRASTIVE, 6, 0))
    want = jdemos.pack_demos(jax_demos(CONTRASTIVE, 6, 0))
    assert set(got) == set(want)
    assert got["missions"] == want["missions"]
    for k in ("lengths", "obss", "actions", "rewards", "targets"):
        assert isinstance(got[k], torch.Tensor), k
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    empty = demos_mod.pack_demos([])
    assert empty["missions"] == [] and empty["lengths"].numel() == 0


def test_generate_demos_main_saves_a_torch_file(tmp_path, capsys):
    out = tmp_path / "demos.pt"
    demos_mod.main(["--env", CONTRASTIVE, "--num-demos", "6", "--out", str(out),
                    "--device", "cpu"])
    assert "collected 5 demos" in capsys.readouterr().out
    loaded = torch.load(out)
    want = demos_mod.pack_demos(port_demos(CONTRASTIVE, 6, 0))
    assert loaded["missions"] == want["missions"]
    for k in ("lengths", "obss", "actions", "rewards", "targets"):
        assert torch.equal(loaded[k], want[k]), k


# -- the port's copies of tests/test_tools.py:17-55 --------------------------------

def test_oracle_solves_contrastive():
    demos = port_demos(CONTRASTIVE, 6, 0)
    assert len(demos) >= 3
    for mission, obss, actions, rewards, target, label in demos:
        assert sum(rewards) > 0  # oracle demos always succeed
        assert mission.startswith("Pickup")
        assert len(obss) == len(actions) == len(rewards)


def test_demo_packing():
    demos = port_demos(CONTRASTIVE, 4, 2)
    packed = demos_mod.pack_demos(demos)
    n = len(demos)
    assert packed["obss"].shape[0] == n
    assert packed["actions"].shape == packed["rewards"].shape
    assert len(packed["missions"]) == n


def test_oracle_bfs_respects_walls():
    _, _, env, state = negated_pair(0)
    agent = oracle.OracleAgent(env, env.default_params, device=CPU)
    target = state.extra["target_cell"][0].numpy()
    path = agent.action_sequence(state, list(target))
    assert path is not None
    g = unpack_np(state.grid[0].numpy())
    for (x, y) in path[:-1]:
        assert g[x, y, 0] != 2  # never walks through walls


@pytest.mark.parametrize("seed", [0, 3])
def test_negated_env_rewards(seed):
    demos = port_demos(NEGATED, 8, seed)
    # oracle demos that complete always end with +1 (target pickup); seed 0
    # has some (JAX's copy of this test runs seed 3 alone, which has none)
    assert len(demos) >= (1 if seed == 0 else 0)
    for d in demos:
        assert d[3][-1] == 1.0
