"""The JAX <-> PyTorch-port bridge, and the port's packed grid and state.

The helpers here turn a JAX pytree into the numpy field dict that
``minigrid_tpu_torch.utils.convert.state_from_numpy`` takes, and compare a port
state with a JAX one field by field; the other ``test_torch_*`` files import
them.  The tests hold the port's cell packing, grid builders and state
conversion bitwise against the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu.core import constants as JC
from minigrid_tpu.core import grid_ops as JG
from minigrid_tpu.core.state import EnvState as JEnvState
from minigrid_tpu.core.state import empty_grid as j_empty_grid

from minigrid_tpu_torch.core import constants as TC
from minigrid_tpu_torch.core import grid_ops as TG
from minigrid_tpu_torch.core.state import EnvState, empty_grid
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

CPU = torch.device("cpu")


# -- bridge helpers (used by the other test_torch_* files) -------------------

def jax_to_numpy(tree) -> dict:
    """A JAX ``EnvState``/``PooledState`` -> numpy fields keyed by name;
    ``None`` leaves (absent box planes, ``extra``) are dropped."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out[f.name] = jax_to_numpy(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def to_port(tree, device=CPU):
    """A JAX state -> the port's state, through numpy."""
    return state_from_numpy(jax_to_numpy(tree), device)


def assert_state_equal(port_state, jax_state, where: str = "") -> None:
    """Every field equal in value AND dtype; ``None`` planes on both sides."""
    got = state_to_numpy(port_state)
    want = jax_to_numpy(jax_state)
    _assert_fields(got, want, where)


def _assert_fields(got: dict, want: dict, where: str) -> None:
    for name, g in got.items():
        w = want.get(name)
        if g is None:
            assert w is None, f"{where}{name}: port has None, JAX has a value"
            continue
        if isinstance(g, dict):
            _assert_fields(g, w, f"{where}{name}.")
            continue
        assert w is not None, f"{where}{name}: JAX has None"
        assert g.dtype == w.dtype, f"{where}{name}: dtype {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{where}{name}")
    extra = set(want) - set(got)
    assert not extra, f"{where}: fields the port lacks: {sorted(extra)}"


def random_packed(rng: np.random.Generator, shape) -> np.ndarray:
    """Random packed cells over the whole type/color/state ranges."""
    cells = np.stack([rng.integers(0, 34, shape), rng.integers(0, 11, shape),
                      rng.integers(0, 3, shape)], axis=-1)
    return JG.pack_np(cells)


# -- constants ----------------------------------------------------------------

def test_constants_are_the_jax_tables():
    for name in ("OBJECT_TO_IDX", "COLOR_TO_IDX", "STATE_TO_IDX"):
        assert getattr(TC, name) == getattr(JC, name), name
    for name in ("DIR_TO_VEC", "CAN_OVERLAP", "CAN_PICKUP", "SEE_BEHIND",
                 "EMPTY_TRIPLE", "UNSEEN_TRIPLE", "WALL_TRIPLE", "GOAL_TRIPLE",
                 "LAVA_TRIPLE", "FLOOR_TRIPLE"):
        got, want = getattr(TC, name), np.asarray(getattr(JC, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# -- packing ------------------------------------------------------------------

def test_pack_unpack_round_trip():
    rng = np.random.default_rng(0)
    cells = np.stack([rng.integers(0, 256, (5, 7)) for _ in range(3)],
                     axis=-1).astype(np.uint8)
    packed = TG.pack_cells(torch.from_numpy(cells))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().astype(np.uint32),
                                  JG.pack_np(cells))
    np.testing.assert_array_equal(
        packed.numpy().astype(np.uint32),
        np.asarray(JG.pack_cells(jnp.asarray(cells))))
    back = TG.unpack_cells(packed)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), cells)
    np.testing.assert_array_equal(TG.pack_np(cells).astype(np.uint32),
                                  JG.pack_np(cells))
    np.testing.assert_array_equal(TG.unpack_np(TG.pack_np(cells)), cells)
    assert TG.pack_word(TC.WALL_TRIPLE) == 0x602


# -- builders -----------------------------------------------------------------

@pytest.mark.parametrize("w,h", [(8, 8), (9, 5)])
def test_builders_match_jax(w, h):
    """wall_rect / put / set_where / read_word / is_empty, with per-grid
    tensor coordinates, against the JAX builders vmapped over the batch."""
    rng = np.random.default_rng(w * 10 + h)
    n = 12
    x = rng.integers(0, w, n).astype(np.int32)
    y = rng.integers(0, h, n).astype(np.int32)
    rw = rng.integers(1, w + 1, n).astype(np.int32)
    rh = rng.integers(1, h + 1, n).astype(np.int32)
    cells = np.stack([rng.integers(0, 34, n), rng.integers(0, 11, n),
                      rng.integers(0, 3, n)], axis=-1).astype(np.uint8)
    mask = rng.random((n, w, h)) < 0.3

    def jax_build(x, y, rw, rh, cell, mask):
        g = JG.wall_rect(j_empty_grid(w, h), x, y, rw, rh)
        g = JG.put(g, y % w, x % h, cell)
        g = JG.set_where(g, mask, JC.LAVA_TRIPLE)
        return g, JG.read_word(g, x, y), JG.is_empty(g)

    want_g, want_word, want_empty = jax.vmap(jax_build)(
        x, y, rw, rh, cells, mask)

    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, y=y, rw=rw, rh=rh).items()}
    g = TG.wall_rect(empty_grid(w, h, CPU, (n,)), t["x"], t["y"], t["rw"], t["rh"])
    g = TG.put(g, t["y"] % w, t["x"] % h, torch.from_numpy(cells))
    g = TG.set_where(g, torch.from_numpy(mask), TC.LAVA_TRIPLE)
    np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(want_g))
    np.testing.assert_array_equal(
        TG.read_word(g, t["x"], t["y"]).numpy().astype(np.uint32),
        np.asarray(want_word))
    np.testing.assert_array_equal(TG.is_empty(g).numpy(), np.asarray(want_empty))

    # host-triple coordinates, one grid
    one = TG.wall_rect(empty_grid(w, h, CPU), 1, 1, w - 2, h - 2)
    one = TG.put(one, w - 2, h - 2, TC.GOAL_TRIPLE)
    ref = JG.put(JG.wall_rect(j_empty_grid(w, h), 1, 1, w - 2, h - 2),
                 w - 2, h - 2, JC.GOAL_TRIPLE)
    np.testing.assert_array_equal(one.numpy().astype(np.uint32), np.asarray(ref))


def test_write_word_writes_one_cell_per_grid():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(random_packed(rng, (4, 6, 5)).astype(np.int32))
    x = torch.tensor([0, 5, 2, 3], dtype=torch.int32)
    y = torch.tensor([4, 0, 2, 1], dtype=torch.int32)
    word = torch.tensor([7, 8, 9, 10], dtype=torch.int32)
    out = TG.write_word(g, x, y, word)
    want = g.clone()
    want[torch.arange(4), x.long(), y.long()] = word
    assert torch.equal(out, want)
    assert not torch.equal(out, g)  # a copy: the input is untouched


# -- state conversion -----------------------------------------------------------

def _jax_state(rng: np.random.Generator, b: int, w: int, h: int,
               has_boxes: bool) -> JEnvState:
    grid = random_packed(rng, (b, w, h))
    trip = lambda: np.stack([rng.integers(0, 34, b), rng.integers(0, 11, b),  # noqa: E731
                             rng.integers(0, 3, b)], -1).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))), b)
    return JEnvState(
        grid=jnp.asarray(grid),
        box_contains=jnp.asarray(random_packed(rng, (b, w, h))) if has_boxes else None,
        agent_pos=jnp.asarray(np.stack([rng.integers(0, w, b), rng.integers(0, h, b)],
                                       -1).astype(np.int32)),
        agent_dir=jnp.asarray(rng.integers(0, 4, b).astype(np.int32)),
        carrying=jnp.asarray(trip()),
        carrying_contains=jnp.asarray(trip()) if has_boxes else None,
        step_count=jnp.asarray(rng.integers(0, 50, b).astype(np.int32)),
        terminated=jnp.asarray(rng.random(b) < 0.5),
        truncated=jnp.asarray(rng.random(b) < 0.5),
        rng=keys,
        mission=jnp.asarray(rng.integers(0, 9, (b, 4)).astype(np.int32)),
        max_steps=jnp.asarray(rng.integers(0, 3, b).astype(np.int32) * 20),
    )


@pytest.mark.parametrize("has_boxes", [False, True])
def test_state_round_trip(has_boxes):
    """state_from_numpy then state_to_numpy returns the JAX fields exactly,
    dtypes included; absent box planes stay None."""
    jstate = _jax_state(np.random.default_rng(2), 6, 7, 5, has_boxes)
    port = to_port(jstate)
    assert isinstance(port, EnvState)
    assert port.grid.dtype == torch.int32 and port.rng.dtype == torch.int64
    assert (port.box_contains is None) == (not has_boxes)
    assert_state_equal(port, jstate)


def test_state_from_numpy_rejects_unknown_fields():
    fields = jax_to_numpy(_jax_state(np.random.default_rng(3), 2, 5, 5, False))
    fields["targets"] = np.zeros(2)
    with pytest.raises(ValueError, match="targets"):
        state_from_numpy(fields, CPU)
