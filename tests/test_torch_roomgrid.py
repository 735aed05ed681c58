"""The port's RoomGrid builder and the draws it adds, against the JAX package.

The draws: ``rng.uniform``, ``rng.categorical`` and ``rng.top_k`` against
``jax.random.uniform``, ``jax.random.categorical`` and ``jax.lax.top_k``, bit
for bit, ties included.  ``categorical`` is held on its index: torch's
``log`` and XLA's differ in the last bit of about a quarter of the floats,
and the index does not see it, because the Gumbel noise is strictly
increasing in the uniform draw under either ``log``.

The builder: each case drives the builder methods of a 3x3 lattice of rooms
of size 6 once, written once for both packages: ``jax.jit(jax.vmap(case))``
on the JAX ``RoomGridEnv`` and the batch call on the port's, with the same 32
keys and the same per-env inputs.  Every builder field (grid, door slots,
door and lock flags, object combos, agent) and every returned triple and
position agree bitwise.  The JAX programs are integer programs but for the
uniform draws, which are exact in any rounding; they compile at optimization
level 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu.core.roomgrid import RoomGridEnv as JRoomGridEnv

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

B = 32
INTEGER_ONLY = {"xla_backend_optimization_level": 0}


def _keys(n: int, seed: int):
    """n JAX keys and the same keys as the port's int64 tensor."""
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


# -- the draws ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(30,), (256,)])
def test_uniform_matches_jax(shape):
    jk, tk = _keys(64, seed=shape[0])
    tiny = float(np.finfo(np.float32).tiny)
    for lo in (0.0, tiny):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, shape, minval=lo, maxval=1.0))(jk))
        got = rng.uniform(tk, shape, lo, 1.0)
        assert got.dtype == torch.float32 and tuple(got.shape) == (64,) + shape
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (want >= tiny).all() and (want < 1).all()


def test_gumbel_noise_is_strictly_increasing_in_u():
    """Every float32 the uniform can give in [tiny, 1) (the 2^23 multiples of
    2^-23, 0 lifted to tiny): ``-log(-log(u))`` strictly increases under
    XLA's ``log`` and under torch's, so the argmax of noise plus 0/-inf
    logits is the argmax of ``u``, whichever ``log`` rounds it."""
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(np.arange(2**23, dtype=np.float32) * np.float32(2**-23) + tiny, tiny)
    want = np.asarray(jax.jit(lambda u: -jnp.log(-jnp.log(u)))(u))
    got = (-torch.log(-torch.log(torch.from_numpy(u)))).numpy()
    assert (np.diff(want) > 0).all() and (np.diff(got) > 0).all()


@pytest.mark.parametrize("n", [4, 1024])
def test_categorical_matches_jax(n):
    """2,048 rows of masked logits (0 or -inf), the first 64 all -inf (index
    0 in both): the indices agree."""
    rows = 2048
    jk, tk = _keys(rows, seed=n)
    r = np.random.default_rng(n)
    mask = r.random((rows, n)) < (0.5 if n == 4 else 0.05)
    mask[:64] = False
    logits = np.where(mask, 0.0, -np.inf).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(jk, logits))
    got = rng.categorical(tk, torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:64] == 0).all()
    assert mask[np.arange(64, rows), want[64:]][mask[64:].any(1)].all()
    with pytest.raises(ValueError):
        rng.categorical(tk, torch.from_numpy(logits), mode="high")


@pytest.mark.parametrize("k", [3, 10, 25])
def test_top_k_matches_jax_on_ties(k):
    """Rows of uniform priorities with -1.0 padding (most entries), exact
    ties between real values, and k above the number of real entries: XLA
    puts equal values lower index first."""
    r = np.random.default_rng(k)
    vals = np.where(r.random((512, 30)) < 0.7, -1.0, r.random((512, 30)))
    vals = vals.astype(np.float32)
    vals[:, 9] = vals[:, 4]
    vals[:, 20] = vals[:, 4]
    vals[:16] = -1.0
    want_v, want_i = jax.vmap(lambda v: jax.lax.top_k(v, k))(vals)
    got_v, got_i = rng.top_k(torch.from_numpy(vals), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# -- the builder ------------------------------------------------------------------

LATTICE = dict(room_size=6, num_rows=3, num_cols=3)
# 2x3 rooms of 4: two free cells a room at most (one in the agent's), so 18
# objects fill rooms and draws come back not ok
SMALL_LATTICE = dict(room_size=4, num_rows=2, num_cols=3)


class JRooms(JRoomGridEnv):
    def __init__(self, **lattice):
        super().__init__(**(lattice or LATTICE))


class Rooms(RoomGridEnv):
    def __init__(self, **lattice):
        super().__init__(**(lattice or LATTICE))


def _jax_split(key, n):
    return list(jax.random.split(key, n))


def _port_split(keys, n):
    return list(rng.split(keys, n).unbind(1))


def case_init_remove_place(env, split, key, x, p):
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    for i, j, wall in ((1, 1, 3), (0, 2, 0), (2, 0, 1), (1, 2, 2)):
        b = env.remove_wall(b, i, j, wall)
    return (b, env.place_agent_in_room(b, k[1], p, 2, 1),
            env.place_agent_in_room(b, k[2], p, x["i"], x["j"]))


def case_add_door(env, split, key, x, p):
    k = split(key, 5)
    b = env.init_rooms(k[0], p)
    b, t1, p1 = env.add_door(b, k[1], 1, 1)
    b, t2, p2 = env.add_door(b, k[2], 1, 1, None, color=x["color9"])
    b, t3, p3 = env.add_door(b, k[3], x["i"], x["j"], enabled=x["on"])
    b, t4, p4 = env.add_door(b, k[4], 0, 2, 0, locked=True, enabled=x["on"])
    return b, (t1, t2, t3, t4), (p1, p2, p3, p4)


def case_connect_all(env, split, key, x, p):
    """With a locked room (its walls ineligible) and without, from an agent
    in a room per env."""
    k = split(key, 5)
    b = env.init_rooms(k[0], p)
    b = env.place_agent_in_room(b, k[1], p, x["i"], x["j"])
    locked, _, _ = env.add_door(b, k[2], 2, 2, 3, locked=True)
    return env.connect_all(locked, k[3]), env.connect_all(b, k[4])


def case_connect_all_exclude(env, split, key, x, p):
    """exclude_color per env (a negative sentinel in some) and static."""
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    b = env.place_agent_in_room(b, k[1], p, 1, 1)
    return (env.connect_all(b, k[2], exclude_color=x["color"]),
            env.connect_all(b, k[2], exclude_color=3))


def case_objects(env, split, key, x, p):
    k = split(key, 5)
    b = env.init_rooms(k[0], p)
    b, t1, p1 = env.add_object(b, k[1], p, 1, 1)
    b, t2, p2 = env.add_object(b, k[2], p, 1, 1, kind="box", color=x["color9"])
    b, t3, p3 = env.add_object(b, k[3], p, x["i"], x["j"], kind="key",
                               enabled=x["on"])
    b, p4, ok = env.place_in_room(b, k[4], p, 0, 0, np.asarray([6, 3, 0], np.uint8),
                                  enabled=False)
    return b, (t1, t2, t3), (p1, p2, p3, p4, ok)


def case_distractors_oneshot_unique(env, split, key, x, p):
    """Objects first (combos taken, cells filled), then more distractors
    than the agent's room has free cells (-1.0 ties decide the order), and
    a few in a corner room per env enabled."""
    k = split(key, 5)
    b = env.init_rooms(k[0], p)
    for n in (1, 2):
        b, _, _ = env.add_object(b, k[n], p, 1, 1)
    b, a1, q1 = env.add_distractors(b, k[3], p, 1, 1, num_distractors=18)
    b, a2, q2 = env.add_distractors(b, k[4], p, 0, 0, num_distractors=5,
                                    enabled=x["on"])
    return b, (a1, a2), (q1, q2)


def case_distractors_oneshot_repeats(env, split, key, x, p):
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    b, a1, q1 = env.add_distractors(b, k[1], p, 0, 2, num_distractors=6,
                                    all_unique=False)
    b, a2, q2 = env.add_distractors(b, k[2], p, 2, 2, num_distractors=4,
                                    all_unique=False, color_override=x["color9"])
    return b, (a1, a2), (q1, q2)


def case_distractors_sequential(env, split, key, x, p):
    """i = j = None: the room drawn per distractor, one draw after another."""
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    b, a1, q1 = env.add_distractors(b, k[1], p, num_distractors=5)
    b, a2, q2 = env.add_distractors(b, k[2], p, num_distractors=4,
                                    all_unique=False, enabled=x["on"])
    return b, (a1, a2), (q1, q2)


def case_distractors_sequential_full(env, split, key, x, p):
    """all_unique with 18 objects on the small lattice, from the agent in
    room (1, 1): rooms fill, so later draws are not ok and set no combo."""
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    b = env.place_agent_in_room(b, k[1], p, 1, 1)
    return env.add_distractors(b, k[2], p, num_distractors=18)


case_distractors_sequential_full.lattice = SMALL_LATTICE


def case_distractors_sequential_fixed(env, split, key, x, p):
    """One room coordinate fixed, the other drawn per object: the column
    as a Python int, then the row per env."""
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    b, a1, q1 = env.add_distractors(b, k[1], p, i=1, num_distractors=6)
    b, a2, q2 = env.add_distractors(b, k[2], p, j=x["j"], num_distractors=5,
                                    all_unique=False)
    return b, (a1, a2), (q1, q2)


def case_distractors_sequential_override(env, split, key, x, p):
    """color_override and enabled per env, with and without uniqueness."""
    k = split(key, 3)
    b = env.init_rooms(k[0], p)
    b, a1, q1 = env.add_distractors(b, k[1], p, num_distractors=6,
                                    color_override=x["color9"], enabled=x["on"])
    b, a2, q2 = env.add_distractors(b, k[2], p, num_distractors=4, all_unique=False,
                                    color_override=x["color9"], enabled=x["on"])
    return b, (a1, a2), (q1, q2)


CASES = [case_init_remove_place, case_add_door, case_connect_all,
         case_connect_all_exclude, case_objects, case_distractors_oneshot_unique,
         case_distractors_oneshot_repeats, case_distractors_sequential,
         case_distractors_sequential_full, case_distractors_sequential_fixed,
         case_distractors_sequential_override]


def _inputs(seed: int) -> dict:
    """Per-env inputs: a room (i, j), a color id or the -1 sentinel, a color
    id, an enable flag."""
    r = np.random.default_rng(seed)
    return {"i": r.integers(0, 3, B).astype(np.int32),
            "j": r.integers(0, 3, B).astype(np.int32),
            "color": r.choice([-1, *range(1, 11)], B).astype(np.int32),
            "color9": r.integers(1, 11, B).astype(np.int32),
            "on": r.random(B) < 0.7}


def _assert_tree_equal(got, want, where: str) -> None:
    if isinstance(got, dict):
        assert set(got) == set(want), where
        for k in got:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
        return
    if isinstance(got, tuple):
        assert len(got) == len(want), where
        for n, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{where}[{n}]")
        return
    g, w = got.numpy(), np.asarray(want)
    if where.endswith(".grid"):  # packed words: int32 in the port, uint32 in JAX
        assert (g.dtype, w.dtype) == (np.int32, np.uint32), where
        g, w = g.astype(np.int64), w.astype(np.int64)
    assert g.dtype == w.dtype, f"{where}: {g.dtype} vs {w.dtype}"
    assert g.shape == w.shape, f"{where}: {g.shape} vs {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_builder_matches_jax(case):
    lattice = getattr(case, "lattice", LATTICE)
    jenv, env = JRooms(**lattice), Rooms(**lattice)
    jp, p = jenv.default_params, env.default_params
    seed = CASES.index(case)
    jkeys, keys = _keys(B, seed)
    x = _inputs(seed)
    program = jax.jit(jax.vmap(lambda k, xs: case(jenv, _jax_split, k, xs, jp)))
    want = program.lower(jkeys, x).compile(INTEGER_ONLY)(jkeys, x)
    got = case(env, _port_split, keys, {k: torch.from_numpy(v) for k, v in x.items()}, p)
    _assert_tree_equal(got, want, case.__name__)
    if case is case_distractors_sequential_full:
        ok = got[0]["obj_mask"].sum(dim=1)  # one combo an object placed
        assert (ok < 18).any() and (ok > 0).all()
