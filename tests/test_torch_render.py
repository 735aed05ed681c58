"""The port's RGB rendering against the JAX package's, bitwise.

The texture atlas is numpy on both sides and equal byte for byte; the
rasterizer's tiles agree at the reference's 32 pixels.  The frames —
``full_render`` with and without the highlight, ``pov_render_batch`` in
both layouts, ``get_frame`` of the whole grid and of the POV — are held
against the JAX functions on 16 DoorKey-8x8 states after a 5-step random
walk, one carrying the key (its overlay in the view) and one with the door
open; the highlighted full render also on the 7x3 KeyCorridorS3R1.  The states come from the port's generator (bitwise JAX's,
``test_torch_zoo_generate.py``) and cross to JAX through numpy.

Every JAX render is an integer program, compiled with
``INTEGER_PROGRAM``'s options (exact for integers, a fraction of the
default compile).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu.ops import render as JR
from minigrid_tpu.utils import rendering as JRast

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.ops import render as R
from minigrid_tpu_torch.utils import rendering as Rast
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.test_torch_babyai_generate_goto import INTEGER_PROGRAM
from tests.test_torch_zoo_step import _jax_state
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
DOORKEY = "MiniGrid-DoorKey-8x8-v0"
NON_SQUARE = "MiniGrid-KeyCorridorS3R1-v0"  # 7 x 3
TILE = 8  # RGBImg*Wrapper's default; the atlas at 32 takes 4x as long to build


def walked_fields(env_id: str = DOORKEY, n: int = 16, walk: int = 5,
                  seed: int = 8) -> dict:
    """``n`` levels of the port's generator after a ``walk``-step random
    walk, as numpy fields; for DoorKey env 0 carries the key and env 1's
    door is open."""
    env = minigrid_tpu_torch.make(env_id)
    params = env.default_params
    st = env.generate(rng.split(rng.PRNGKey(seed, CPU), n), params, CPU)
    r = np.random.default_rng(seed)
    for _ in range(walk):
        a = torch.from_numpy(r.integers(0, env.num_actions, n).astype(np.int32))
        st = env.step_state(st, a, params)[0]
    f = state_to_numpy(st)
    if env_id == DOORKEY:
        f["carrying"][0] = (C.OBJECT_TO_IDX["key"], C.COLOR_TO_IDX["yellow"], 0)
        g = f["grid"][1]
        door = (g & 0xFF) == C.OBJECT_TO_IDX["door"]
        assert door.sum() == 1
        g[door] &= 0xFFFF  # state 0: open
    return f


def jax_program(fn, *args):
    """``fn`` jitted and compiled for ``args`` as an integer program."""
    return jax.jit(fn).lower(*args).compile(INTEGER_PROGRAM)


@pytest.fixture(scope="module")
def doorkey():
    """(fields, port states, JAX states, port params, JAX params)."""
    f = walked_fields()
    jp = minigrid_tpu.make(DOORKEY).default_params
    return f, state_from_numpy(f, CPU), _jax_state(f), \
        minigrid_tpu_torch.make(DOORKEY).default_params, jp


def test_atlas_is_the_jax_atlas_byte_for_byte():
    got = R.atlas_np(TILE)
    want = JR.get_atlas(TILE)
    assert got.shape == (R.NUM_VARIANTS, R.NUM_CODES, TILE, TILE, 3) == want.shape
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    dev = R.get_atlas(TILE, CPU)
    assert dev is R.get_atlas(TILE, "cpu")  # moved once per (tile, device)
    np.testing.assert_array_equal(dev.numpy(), want)


@pytest.mark.parametrize("t,c,s,agent_dir,hl", [
    (C.OBJECT_TO_IDX["door"], C.COLOR_TO_IDX["yellow"], 2, None, False),
    (C.OBJECT_TO_IDX["door"], C.COLOR_TO_IDX["blue"], 0, 1, True),
    (C.OBJECT_TO_IDX["key"], C.COLOR_TO_IDX["orange"], 0, 3, False),
    (C.OBJECT_TO_IDX["lava"], 0, 0, 0, True),
    (C.OBJECT_TO_IDX["gripped_block"], C.COLOR_TO_IDX["cyan"], 0, None, True),
    (C.OBJECT_TO_IDX["flower"], C.COLOR_TO_IDX["purple"], 1, 2, False),
    (C.OBJECT_TO_IDX["west"], C.COLOR_TO_IDX["grey"], 0, None, False),
    (C.OBJECT_TO_IDX["empty"], 0, 0, 2, True),
])
def test_render_tile_matches_jax_at_32_pixels(t, c, s, agent_dir, hl):
    got = Rast.render_tile(t, c, s, agent_dir, hl, tile_size=C.TILE_PIXELS)
    want = JRast.render_tile(t, c, s, agent_dir, hl, tile_size=C.TILE_PIXELS)
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_cell_codes_match_jax(doorkey):
    f, st, js, _, _ = doorkey
    want = np.asarray(jax.vmap(JR.cell_codes)(js.grid))
    np.testing.assert_array_equal(R.cell_codes(st.grid).numpy(), want)


# (port render, JAX render over the batch); each frame uint8
RENDERS = {
    "full_highlight": (
        lambda s, p, a: R.full_render(s, p, a, highlight=True),
        lambda s, p, a: jax.vmap(lambda x: JR.full_render(x, p, a, highlight=True))(s)),
    "full_plain": (
        lambda s, p, a: R.full_render(s, p, a, highlight=False),
        lambda s, p, a: jax.vmap(lambda x: JR.full_render(x, p, a, highlight=False))(s)),
    "pov_hwc": (
        lambda s, p, a: R.pov_render_batch(s, p, a),
        lambda s, p, a: JR.pov_render_batch(s, p, a)),
    "pov_chw": (
        lambda s, p, a: R.pov_render_batch(s, p, a, channels_first=True),
        lambda s, p, a: JR.pov_render_batch(s, p, a, channels_first=True)),
    "pov_per_env": (
        lambda s, p, a: R.pov_render(s, p, a),
        lambda s, p, a: jax.vmap(lambda x: JR.pov_render(x, p, a))(s)),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_matches_jax(doorkey, name):
    f, st, js, p, jp = doorkey
    port_fn, jax_fn = RENDERS[name]
    got = port_fn(st, p, R.get_atlas(TILE, CPU))
    want = np.asarray(jax_program(lambda s: jax_fn(s, jp, JR.get_atlas(TILE)), js)(js))
    v = p.agent_view_size * TILE
    shape = {"full_highlight": (16, 64, 64, 3), "full_plain": (16, 64, 64, 3),
             "pov_hwc": (16, v, v, 3), "pov_chw": (16, 3, v, v),
             "pov_per_env": (16, v, v, 3)}[name]
    assert tuple(got.shape) == shape and got.dtype == torch.uint8
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "pov_hwc":
        # the carried key sits at the agent's cell: (V//2, V-1) in view
        # cells, the bottom-middle tile of the frame
        tile = got[0, v - TILE:, (v - TILE) // 2:(v + TILE) // 2]
        assert (tile[..., 0] == 255).any()  # the agent triangle is red


def test_full_render_matches_jax_on_a_non_square_grid():
    """KeyCorridorS3R1 is 7 wide and 3 high, smaller than the 7-cell view:
    a W/H mix-up in the highlight's scatter or in the frame layout, which a
    square grid hides, shows here."""
    f = walked_fields(NON_SQUARE, n=8)
    st, js = state_from_numpy(f, CPU), _jax_state(f)
    p = minigrid_tpu_torch.make(NON_SQUARE).default_params
    jp = minigrid_tpu.make(NON_SQUARE).default_params
    assert (p.width, p.height) == (7, 3)
    got = R.full_render(st, p, R.get_atlas(TILE, CPU), highlight=True)
    want = jax_program(jax.vmap(lambda s: JR.full_render(
        s, jp, JR.get_atlas(TILE), highlight=True)), js)(js)
    assert tuple(got.shape) == (8, 3 * TILE, 7 * TILE, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not R.highlight_mask(st, p).all()  # some cells lie outside the view


def test_get_atlas_defaults_to_the_card():
    """Like every entry point, the atlas goes to CUDA unless the caller
    names a device; without a card that raises."""
    if torch.cuda.is_available():
        assert R.get_atlas(TILE).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            R.get_atlas(TILE)


@pytest.mark.parametrize("agent_pov", [False, True])
def test_get_frame_matches_jax(doorkey, agent_pov):
    f, st, js, p, jp = doorkey
    env = minigrid_tpu_torch.make(DOORKEY)
    jenv = minigrid_tpu.make(DOORKEY)
    got = env.get_frame(st, p, tile_size=TILE, agent_pov=agent_pov)
    want = jax_program(jax.vmap(lambda s: jenv.get_frame(
        s, jp, tile_size=TILE, agent_pov=agent_pov)), js)(js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_highlight_is_the_visible_world_cells(doorkey):
    """The highlight marks exactly the in-bounds visible view cells, from
    the state's own view size."""
    from minigrid_tpu_torch.core.obs import gen_obs_grid_batch, view_world_coords

    _, st, _, p, _ = doorkey
    mask = R.highlight_mask(st, p)
    wx, wy = view_world_coords(st.agent_pos, st.agent_dir, p.agent_view_size)
    _, vis = gen_obs_grid_batch(st, p)
    inb = (wx >= 0) & (wx < p.width) & (wy >= 0) & (wy < p.height)
    assert torch.equal(mask.sum(dim=(1, 2)), (vis & inb).sum(dim=(1, 2)))
    b = torch.arange(16)[:, None, None].expand_as(wx)
    assert mask[b[vis & inb], wx[vis & inb], wy[vis & inb]].all()
