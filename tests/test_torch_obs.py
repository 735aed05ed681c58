"""The port's observation pipeline against the JAX package, bitwise.

The window gather's plain version (the CPU path of
``minigrid_tpu_torch.ops.obs_gather``) is held against JAX's
``gather_view_gather`` and against the Pallas kernel
``gather_view_pallas_packed`` run in the Pallas interpreter, over every
direction x pose; then ``process_vis`` and the whole ``gen_obs_batch``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.core import constants as JC
from minigrid_tpu.core.grid_ops import pack_np
from minigrid_tpu.core.obs import gather_view_gather
from minigrid_tpu.core.obs import gen_obs_batch as j_gen_obs_batch
from minigrid_tpu.core.obs import process_vis as j_process_vis
from minigrid_tpu.core.obs import view_world_coords as j_view_world_coords
from minigrid_tpu.core.obs import _view_exts as j_view_exts
from minigrid_tpu.ops import obs_pallas

from minigrid_tpu_torch.core import obs as TO
from minigrid_tpu_torch.core.state import EnvParams, base_state
from minigrid_tpu_torch.ops import obs_gather

from tests.test_torch_bridge import random_packed, to_port
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run JAX's Pallas window kernel in the interpreter (no TPU here)."""
    monkeypatch.setattr(obs_pallas, "INTERPRET", True)
    monkeypatch.setattr(obs_pallas, "OBS_IMPL", "pallas")


def _all_poses(w: int, h: int, pad_to: int = 128):
    """Every (x, y, dir), padded to a multiple of 128 envs (the Pallas
    kernel's lane block) by repeating the first poses."""
    combos = [(x, y, d) for x in range(w) for y in range(h) for d in range(4)]
    pad = (-len(combos)) % pad_to
    combos = combos + (combos * (pad // len(combos) + 1))[:pad]
    pos = np.array([(x, y) for x, y, _ in combos], dtype=np.int32)
    dirs = np.array([d for _, _, d in combos], dtype=np.int32)
    return pos, dirs


@pytest.mark.parametrize("w,h,v", [(8, 8, 7), (9, 5, 7), (6, 9, 5)])
def test_view_coords_match_jax(w, h, v):
    pos, dirs = _all_poses(w, h, pad_to=1)
    wx, wy = TO.view_world_coords(torch.from_numpy(pos), torch.from_numpy(dirs), v)
    jwx, jwy = jax.vmap(lambda p, d: j_view_world_coords(p, d, v))(pos, dirs)
    np.testing.assert_array_equal(wx.numpy(), np.asarray(jwx))
    np.testing.assert_array_equal(wy.numpy(), np.asarray(jwy))
    tx, ty = TO._view_exts(torch.from_numpy(pos), torch.from_numpy(dirs), v)
    jtx, jty = jax.vmap(lambda p, d: j_view_exts(p, d, v))(pos, dirs)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jtx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jty))


@pytest.mark.parametrize("w,h,v", [(8, 8, 7), (9, 5, 7), (6, 9, 5)])
def test_gather_view_all_dirs_all_poses(pallas_interpret, w, h, v):
    """The port's window == JAX gather_view_gather == the interpreted Pallas
    kernel + its rotation epilogue, for every direction x pose on one random
    grid per env (edges included, where the window reads out of bounds)."""
    rng = np.random.default_rng(w * 100 + h * 10 + v)
    pos, dirs = _all_poses(w, h)
    grids = random_packed(rng, (len(dirs), w, h))
    got = obs_gather.gather_view(torch.from_numpy(grids.astype(np.int32)),
                                 torch.from_numpy(pos), torch.from_numpy(dirs), v)
    assert got.dtype == torch.int32 and got.shape == (len(dirs), v, v)
    got = got.numpy().astype(np.uint32)
    ref = jax.vmap(lambda g, p, d: gather_view_gather(g, p, d, v))(grids, pos, dirs)
    np.testing.assert_array_equal(got, np.asarray(ref))
    pallas = obs_pallas.gather_view_pallas_packed(
        jnp.asarray(grids), jnp.asarray(pos), jnp.asarray(dirs), v)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    # the plain version IS the wrapper's CPU path
    np.testing.assert_array_equal(
        obs_gather.gather_view_plain(torch.from_numpy(grids.astype(np.int32)),
                                     torch.from_numpy(pos), torch.from_numpy(dirs),
                                     v).numpy().astype(np.uint32), got)


@pytest.mark.parametrize("v", [3, 5, 7, 11])
def test_process_vis_matches_jax(v):
    """Occlusion over random views, walls and doors (all states) dense
    enough that shadows form in every direction."""
    rng = np.random.default_rng(v)
    n = 96
    typ = rng.choice([JC.OBJECT_TO_IDX[t] for t in
                      ("empty", "empty", "empty", "wall", "door", "key")], (n, v, v))
    st = rng.integers(0, 3, (n, v, v))
    cells = pack_np(np.stack([typ, rng.integers(0, 11, (n, v, v)), st], -1))
    got = TO.process_vis(torch.from_numpy(cells.astype(np.int32)), v)
    want = jax.vmap(lambda c: j_process_vis(c, v))(cells)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1


def test_see_behind_matches_table():
    types = np.arange(JC.NUM_OBJECT_TYPES)
    cells = np.stack([np.repeat(types, 3), np.zeros(3 * len(types), int),
                      np.tile(np.arange(3), len(types))], -1)
    packed = torch.from_numpy(pack_np(cells).astype(np.int32))
    want = JC.SEE_BEHIND[cells[:, 0]] & ((cells[:, 0] != JC.OBJECT_TO_IDX["door"])
                                         | (cells[:, 2] == 0))
    np.testing.assert_array_equal(TO.see_behind(packed).numpy(), want)


@pytest.mark.parametrize("impl", ["vmap", "pallas"])
def test_gen_obs_batch_matches_jax(monkeypatch, impl):
    """The whole observation dict on bridged DoorKey-8x8 states after a
    random walk, half of them carrying the key (the overlay at the agent
    cell), against JAX gen_obs_batch on its vmap path and on its Pallas path
    (interpreted)."""
    monkeypatch.setattr(obs_pallas, "INTERPRET", True)
    monkeypatch.setattr(obs_pallas, "OBS_IMPL", impl)
    env = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0")
    jparams = env.default_params
    n = 128
    states = jax.vmap(lambda k: env.generate(k, jparams))(
        jax.random.split(jax.random.PRNGKey(7), n))
    step = jax.jit(jax.vmap(lambda s, a: env.step_state(s, a, jparams)))
    r = np.random.default_rng(0)
    for _ in range(6):
        states = step(states, jnp.asarray(r.integers(0, 8, n), jnp.int32))[0]
    key = np.array([JC.OBJECT_TO_IDX["key"], JC.COLOR_TO_IDX["yellow"], 0], np.uint8)
    carry = np.where((np.arange(n) % 2 == 0)[:, None], key,
                     np.asarray(states.carrying))
    states = states.replace(carrying=jnp.asarray(carry))
    want = j_gen_obs_batch(states, jparams)
    params = EnvParams(width=8, height=8, max_steps=jparams.max_steps)
    got = TO.gen_obs_batch(to_port(states), params)
    assert set(got) == {"image", "direction", "mission"}
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    agent = got["image"][:, 3, 6].numpy()
    np.testing.assert_array_equal(agent[::2], np.broadcast_to(key, (n // 2, 3)))


def test_see_through_walls_mask_is_all_visible():
    rng = np.random.default_rng(1)
    grids = torch.from_numpy(random_packed(rng, (4, 6, 6)).astype(np.int32))
    st = base_state(grids, torch.full((4, 2), 2, dtype=torch.int32),
                    torch.arange(4, dtype=torch.int32),
                    torch.zeros((4, 2), dtype=torch.int64), has_boxes=False)
    cells, vis = TO.gen_obs_grid_batch(st, EnvParams(width=6, height=6,
                                                     see_through_walls=True))
    assert vis.all() and cells.shape == (4, 7, 7)
