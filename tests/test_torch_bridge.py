"""The JAX <-> PyTorch-port bridge, and the port's packed grid and state.

The helpers here turn a JAX pytree into the numpy field dict that
``minigrid_tpu_torch.utils.convert.state_from_numpy`` takes, and compare a port
state with a JAX one field by field; the other ``test_torch_*`` files import
them.  The tests hold the port's cell packing, grid builders and state
conversion bitwise against the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

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
# the ids of the JAX registry, every one of which the port registers
PORT_ID_COUNT = 171


# -- the port's test modules yield the CPU under pytest-xdist -----------------------

# The niceness a port test module runs at under xdist: the JAX package's long
# files on the other workers win every core they want, and the port's tests
# take the cycles left over.
PORT_TEST_NICE = 19


def _set_nice(nice: int) -> None:
    """Every thread of this process (XLA's and torch's pools included) at
    niceness ``nice``; threads started later inherit it."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.setpriority(os.PRIO_PROCESS, int(tid), nice)
        except (ProcessLookupError, PermissionError):
            pass  # a thread that has just ended


@pytest.fixture(scope="module", autouse=True)
def yield_cpu():
    """Under pytest-xdist, run the importing module with torch on one thread
    and, where the process may raise its priority back afterwards (root), at
    niceness ``PORT_TEST_NICE``; both restored at the module's end.  The
    suite's wall is the JAX package's long files (the distribution tests,
    the conformance sweep), each alone on its worker; at equal priority the
    port's files, which run torch on a thread per core beside them, nearly
    doubled their time.  Without xdist nothing changes."""
    if not os.environ.get("PYTEST_XDIST_WORKER", "").startswith("gw"):
        yield
        return
    threads = torch.get_num_threads()
    nice = os.getpriority(os.PRIO_PROCESS, 0)
    restorable = os.geteuid() == 0
    if restorable:
        _set_nice(max(nice, PORT_TEST_NICE))
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if restorable:
            _set_nice(nice)


# -- bridge helpers (used by the other test_torch_* files) -------------------

def _numpy_tree(v):
    """Arrays to numpy through dicts and dataclasses (BabyAI's instruction
    code and verifier state), a dataclass becoming a dict keyed by its field
    names."""
    if dataclasses.is_dataclass(v):
        return {f.name: _numpy_tree(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _numpy_tree(x) for k, x in v.items()}
    return np.asarray(v)


def jax_to_numpy(tree) -> dict:
    """A JAX ``EnvState``/``PooledState`` -> numpy fields keyed by name;
    ``None`` leaves (absent box planes, ``extra``) are dropped, and a dict
    ``extra`` becomes a dict of arrays (a dataclass in it a dict too)."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out[f.name] = jax_to_numpy(v)
        elif isinstance(v, dict):
            out[f.name] = _numpy_tree(v)
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


def assert_registry_complete() -> None:
    """The port registers exactly the JAX registry's ids: PORT_ID_COUNT."""
    import minigrid_tpu
    import minigrid_tpu_torch

    ids = minigrid_tpu_torch.registered_ids()
    assert len(ids) == PORT_ID_COUNT
    assert set(ids) == set(minigrid_tpu.registered_ids())


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


# -- placement draws ------------------------------------------------------------

def _jax_keys(n: int, seed: int):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("w,h", [(8, 8), (9, 5)])
def test_sample_cell_matches_jax(w, h):
    """Masks of every density, some empty (ok False, pos (0, 0))."""
    rng = np.random.default_rng(w + h)
    n = 32
    density = np.linspace(0, 1, n)[:, None, None]
    mask = rng.random((n, w, h)) < density
    mask[3] = False
    jk, tk = _jax_keys(n, seed=w * h)
    want_pos, want_ok = jax.vmap(JG.sample_cell)(jk, jnp.asarray(mask))
    pos, ok = TG.sample_cell(tk, torch.from_numpy(mask))
    assert pos.dtype == torch.int32 and ok.dtype == torch.bool
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert not ok[3] and ok[-1]
    assert mask[np.arange(n)[ok.numpy()], pos[ok, 0].numpy(), pos[ok, 1].numpy()].all()


@pytest.mark.parametrize("triple", [None, (5, 3, 0)])
def test_place_obj_matches_jax(triple):
    """Random grids, the agent's cell excluded, a search rectangle that
    runs past the grid, and a reject mask; with and without a write."""
    rng = np.random.default_rng(7)
    n, w, h = 24, 7, 6
    cells = np.stack([rng.choice([1, 1, 1, 2, 21], (n, w, h)),
                      rng.integers(0, 11, (n, w, h)), np.zeros((n, w, h), int)], -1)
    cells[5, ..., 0] = 2  # all wall: nowhere to place (ok False)
    grid = JG.pack_np(cells)
    agent = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1).astype(np.int32)
    reject = rng.random((n, w, h)) < 0.2
    jk, tk = _jax_keys(n, seed=1)
    jtriple = None if triple is None else np.asarray(triple, np.uint8)

    def jplace(k, g, a, rej):
        return JG.place_obj(k, g, jtriple, agent_pos=a, top=(1, 2), size=(9, 3),
                            reject_mask=rej)

    want_g, want_pos, want_ok = jax.vmap(jplace)(jk, jnp.asarray(grid), jnp.asarray(agent),
                                                  jnp.asarray(reject))
    got_g, pos, ok = TG.place_obj(tk, torch.from_numpy(grid.astype(np.int32)), triple,
                                  agent_pos=torch.from_numpy(agent), top=(1, 2),
                                  size=(9, 3), reject_mask=torch.from_numpy(reject))
    np.testing.assert_array_equal(got_g.numpy().astype(np.uint32), np.asarray(want_g))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert ok.any() and not ok[5]


def test_rect_mask_matches_jax():
    for top, size in [((0, 0), (8, 8)), ((-2, 3), (4, 9)), ((5, 1), (2, 2))]:
        want = JG.rect_mask(8, 6, top, size)
        got = TG.rect_mask(8, 6, top, size, CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the fused planes -----------------------------------------------------------

@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-5x5-v0", "MiniGrid-DoorKey-8x8-v0"])
def test_fused_state_round_trip(env_id):
    """JAX FusedVectorEnv planes -> the port's -> back, exactly; the pad
    lanes of Empty-5x5 (49 lanes for 25 cells) come back as grey walls."""
    import minigrid_tpu
    from minigrid_tpu.ops.fused_step import FusedVectorEnv as JFusedVectorEnv

    from minigrid_tpu_torch.utils.convert import (
        fused_state_from_numpy,
        fused_state_to_numpy,
    )

    jfv = JFusedVectorEnv(minigrid_tpu.make(env_id), 8, block=8)
    _, jfs = jfv.reset(jax.random.PRNGKey(1))
    fields = {k: np.asarray(v) for k, v in jfs.items()}
    w = h = int(env_id.split("-")[-2].split("x")[0])
    fs = fused_state_from_numpy(fields, w, h, CPU)
    assert fs["grid"].shape == (8, w, h) and fs["grid"].dtype == torch.int32
    assert fs["rng"].dtype == torch.int64 and fs["t"].shape == ()
    back = fused_state_to_numpy(fs, jfv._lanes)
    for k, v in fields.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if jfv._lanes > w * h:
        assert (back["grid"][:, w * h:] == TG.pack_word(TC.WALL_TRIPLE)).all()
    with pytest.raises(ValueError):
        fused_state_to_numpy(fs, w * h - 1)
    with pytest.raises(ValueError):
        fused_state_from_numpy({**fields, "extra": fields["t"]}, w, h, CPU)
