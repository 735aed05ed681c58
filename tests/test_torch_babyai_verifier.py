"""The port's BabyAI verifier against the JAX package's, on seeded random
instructions and states.

Every check runs the same numpy inputs through the port's batch-first
function and through ``jax.jit(jax.vmap(...))`` of the JAX one:

* the instruction constructors (``desc``, ``single_clause``, ``pad_clauses``,
  ``and_instr``, ``seq_instr``) and ``num_navs``;
* ``desc_match_mask`` with and without a room mask, one desc and many;
* ``pack_planes``/``unpack_planes`` on 32-high masks (bit 31 set), and the
  ``ValueError`` above 32;
* ``init_verifier_state`` on one-clause and four-clause codes;
* ``verify_step`` after ``base_step`` on 7x7 rooms dense with keys, balls,
  boxes and doors, the agent dropped in facing an object, through 32 steps
  of actions weighted towards pickup, drop, toggle and done (every other
  step half of them ``done`` when that mode is on), for one-clause
  and four-clause codes (single, Before, After, And, And operands) with
  ``done_actions`` off and on.  Each step's status and every field of the
  verifier state agree; each clause kind and each sequencing kind is seen to
  succeed and to fail;
* ``putnext_valid`` on shared, adjacent and separate move/fixed sets.

The JAX programs are integer programs and compile at optimization level 0
with fusion off: neither can change an integer, and together they cut the
compile several times.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.babyai import verifier as JV
from minigrid_tpu.core.state import EnvParams as JEnvParams
from minigrid_tpu.core.step import base_step as j_base_step

import minigrid_tpu_torch
from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import EnvParams
from minigrid_tpu_torch.core.step import base_step
from minigrid_tpu_torch.utils.convert import state_from_numpy

from tests.test_torch_bridge import _numpy_tree
from tests.test_torch_zoo_step import _jax_state
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

INTEGER_PROGRAM = {"xla_backend_optimization_level": 0,
                   "xla_disable_hlo_passes": "fusion"}
CPU = torch.device("cpu")
W = H = 7
B, STEPS = 1024, 32
_KINDS = [C.OBJECT_TO_IDX[t] for t in ("key", "ball", "box", "door")]
_ACTIONS = np.asarray([0, 1, 2, 3, 4, 5, 6])
_ACTION_P = np.asarray([1, 1, 2, 3, 3, 3, 2], float) / 15


def jit_integer(fn, *args):
    """``jax.jit(jax.vmap(fn))`` compiled for ``args`` as an integer
    program."""
    return jax.jit(jax.vmap(fn)).lower(*args).compile(INTEGER_PROGRAM)


def instr_jax(d: dict) -> JV.InstrCode:
    return JV.InstrCode(**{k: jnp.asarray(v) for k, v in d.items()})


def port_numpy(tree) -> dict:
    """A port dict of tensors -> numpy, packed planes as the JAX package's
    uint32."""
    def leaf(t):
        a = t.numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a
    return {k: leaf(v) for k, v in tree.items()}


def assert_tree_equal(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{where}{k}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=where + k)


# -- seeded scenarios -----------------------------------------------------------

def random_rooms(r: np.random.Generator, n: int) -> dict:
    """n 7x7 rooms, each with 10 keys/balls/boxes/doors in three colors on a
    5x5 floor, the agent on an empty cell facing a neighbour object where it
    has one, a third of them carrying something."""
    grid = np.full((n, W, H), C.OBJECT_TO_IDX["empty"], np.uint32)
    wall = C.OBJECT_TO_IDX["wall"] | (C.COLOR_TO_IDX["grey"] << 8)
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = wall
    pos = np.zeros((n, 2), np.int32)
    direction = r.integers(0, 4, n).astype(np.int32)
    inner = [(x, y) for x in range(1, W - 1) for y in range(1, H - 1)]
    for b in range(n):
        cells = r.permutation(len(inner))
        for c in cells[:10]:
            t = r.choice(_KINDS)
            state = r.integers(0, 3) if t == C.OBJECT_TO_IDX["door"] else 0
            grid[b][inner[c]] = t | (r.integers(1, 4) << 8) | (state << 16)
        pos[b] = inner[cells[10]]
        facing = [d for d in range(4)
                  if grid[b][tuple(pos[b] + C.DIR_TO_VEC[d])] & 0xFF in _KINDS]
        if facing and r.random() < 0.8:
            direction[b] = r.choice(facing)
    carrying = np.tile(np.asarray(C.EMPTY_TRIPLE), (n, 1))
    held = r.random(n) < 0.3
    carrying[held, 0] = r.choice(_KINDS[:3], held.sum())
    carrying[held, 1] = r.integers(1, 4, held.sum())
    return {"grid": grid, "agent_pos": pos, "agent_dir": direction,
            "carrying": carrying.astype(np.uint8)}


def random_desc(r: np.random.Generator, grid: np.ndarray,
                faced: tuple | None = None) -> np.ndarray:
    """A desc of an object of the grid (more often than not the one the
    agent faces, when given), its color or type sometimes a wildcard,
    sometimes with a location."""
    if faced is not None and r.random() < 0.6:
        word = int(grid[faced])
    else:
        xs, ys = np.nonzero(np.isin(grid & 0xFF, _KINDS))
        i = r.integers(len(xs))
        word = int(grid[xs[i], ys[i]])
    local = {C.OBJECT_TO_IDX["key"]: 3, C.OBJECT_TO_IDX["ball"]: 2,
             C.OBJECT_TO_IDX["box"]: 1, C.OBJECT_TO_IDX["door"]: 4}[word & 0xFF]
    color = (word >> 8) & 0xFF
    return np.asarray([0 if r.random() < 0.2 else local,
                       0 if r.random() < 0.3 else color,
                       r.integers(1, 5) if r.random() < 0.2 else 0], np.int32)


def faced_objects(rooms: dict) -> list:
    """The cell each agent faces where it holds an object, else None."""
    out = []
    for g, p, d in zip(rooms["grid"], rooms["agent_pos"], rooms["agent_dir"]):
        cell = tuple(p + C.DIR_TO_VEC[d])
        out.append(cell if g[cell] & 0xFF in _KINDS else None)
    return out


def random_instr(r: np.random.Generator, grids: np.ndarray, k: int,
                 faced: list | None = None) -> dict:
    """Codes of k = 1 (one clause) or k = 4 slots (single, Before, After,
    And; And operands), as the level generators build them.  Four-slot codes
    lean on GoTo, the clause that succeeds most often, so that sequences
    complete."""
    kinds = (V.K_GOTO, V.K_PICKUP, V.K_OPEN, V.K_PUTNEXT)
    p = (0.25, 0.25, 0.25, 0.25) if k == 1 else (0.55, 0.15, 0.15, 0.15)
    n = grids.shape[0]
    out = {"seq_kind": np.zeros(n, np.int32), "a_and": np.zeros(n, bool),
           "b_and": np.zeros(n, bool), "kinds": np.zeros((n, k), np.int32),
           "d1": np.zeros((n, k, 3), np.int32), "d2": np.zeros((n, k, 3), np.int32),
           "strict": np.zeros((n, k), bool)}
    for b in range(n):
        seq = 0 if k == 1 else int(r.integers(0, 4))
        a_and = k == 4 and r.random() < 0.4
        b_and = k == 4 and seq != 0 and r.random() < 0.4
        used = [0] + ([1] if a_and else []) + ([2] if seq else []) + ([3] if b_and else [])
        out["seq_kind"][b], out["a_and"][b], out["b_and"][b] = seq, a_and, b_and
        for s in used:
            out["kinds"][b, s] = r.choice(kinds, p=p)
            out["d1"][b, s] = random_desc(r, grids[b], None if faced is None else faced[b])
            out["d2"][b, s] = random_desc(r, grids[b])
            out["strict"][b, s] = r.random() < 0.5
    return out


def room_masks(r: np.random.Generator, n: int) -> np.ndarray:
    """A random rectangle of the grid per env."""
    m = np.zeros((n, W, H), bool)
    for b in range(n):
        x0, y0 = r.integers(0, 4, 2)
        x1, y1 = r.integers(4, 8, 2)
        m[b, x0:x1, y0:y1] = True
    return m


# -- constructors, masks, planes -----------------------------------------------

def test_instruction_constructors_match_jax():
    r = np.random.default_rng(0)
    n = 32
    t = r.choice([0] + _KINDS, n).astype(np.int32)
    c = r.integers(0, 7, n).astype(np.int32)
    loc = r.integers(0, 5, n).astype(np.int32)
    kind = r.integers(1, 5, (4, n)).astype(np.int32)
    strict = r.random((4, n)) < 0.5
    seq = r.integers(1, 3, n).astype(np.int32)

    def build(desc, single, and_, seq_instr, pad, t, c, loc, kind, strict, seq):
        d1, d2 = desc(t, c, loc), desc(c * 0 + t, c, 0)
        s = [single(kind[i], d1, d2, strict[i]) for i in range(4)]
        return (pad(s[0]), and_(s[0], s[1]), seq_instr(seq, s[2], and_(s[0], s[3])),
                seq_instr(seq, and_(s[1], s[2]), s[3]))

    def jax_case(t, c, loc, kind, strict, seq):
        return build(JV.desc, lambda k, a, b, s: JV.single_clause(k, a, b, s),
                     JV.and_instr, JV.seq_instr, JV.pad_clauses, t, c, loc, kind,
                     strict, seq)

    args = (t, c, loc, kind.T, strict.T, seq)
    want = jit_integer(jax_case, *args)(*args)
    tt = [torch.from_numpy(a) for a in (t, c, loc, kind, strict, seq)]
    got = build(V.desc, lambda k, a, b, s: V.single_clause(k, a, b, s), V.and_instr,
                V.seq_instr, V.pad_clauses, *tt)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_tree_equal(port_numpy(g), _numpy_tree(w), f"case {i}: ")
        np.testing.assert_array_equal(V.num_navs(g).numpy(),
                                      np.asarray(jax.vmap(JV.num_navs)(w)))
    assert V.num_navs(got[2]).dtype == torch.int32


@pytest.mark.parametrize("room", [False, True])
def test_desc_match_mask_matches_jax(room):
    r = np.random.default_rng(1 + room)
    rooms = random_rooms(r, 64)
    rooms["agent_dir"] = r.integers(0, 4, 64).astype(np.int32)
    descs = np.stack([np.stack([random_desc(r, g) for _ in range(3)])
                      for g in rooms["grid"]])
    descs[:, 0, 2] = np.arange(64) % 5  # every location
    mask = room_masks(r, 64) if room else None

    def one(g, d, p, dr, m=None):
        return jax.vmap(JV.desc_match_mask, in_axes=(None, 0, None, None, None))(
            g, d, p, dr, m)

    args = [rooms["grid"], descs, rooms["agent_pos"], rooms["agent_dir"]] + (
        [mask] if room else [])
    want = np.asarray(jit_integer(one, *args)(*args))
    targs = [torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint32 else a)
             for a in args]
    targs += [] if room else [None]
    got = V.desc_match_mask(*targs)
    assert got.dtype == torch.bool and got.shape == (64, 3, W, H)
    np.testing.assert_array_equal(got.numpy(), want)
    one_desc = V.desc_match_mask(targs[0], targs[1][:, 1], *targs[2:])
    np.testing.assert_array_equal(one_desc.numpy(), want[:, 1])
    assert want.any(axis=(2, 3)).mean() > 0.5  # most descs match something


def test_packed_planes_match_jax_and_refuse_tall_grids():
    r = np.random.default_rng(3)
    m = r.random((16, 4, 9, 32)) < 0.5
    m[:, :, :, 31] = True  # bit 31: above int32
    want = np.asarray(jax.jit(JV.pack_planes)(m))
    got = V.pack_planes(torch.from_numpy(m))
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.max()) >= 1 << 31
    np.testing.assert_array_equal(V.unpack_planes(got, 32).numpy(), m)
    x, y = torch.tensor([0, 8]), torch.tensor([31, 0])
    np.testing.assert_array_equal(
        V.onehot_packed(9, x, y).numpy().astype(np.uint32),
        np.stack([np.asarray(JV.onehot_packed(9, jnp.int32(a), jnp.int32(b)))
                  for a, b in ((0, 31), (8, 0))]))
    with pytest.raises(ValueError):
        V.pack_planes(torch.zeros((2, 4, 5, 33), dtype=torch.bool))
    with pytest.raises(ValueError):
        JV.pack_planes(jnp.zeros((4, 5, 33), bool))


@pytest.mark.parametrize("k", [1, 4])
def test_init_verifier_state_matches_jax(k):
    r = np.random.default_rng(4 + k)
    rooms = random_rooms(r, 64)
    instr = random_instr(r, rooms["grid"], k)
    mask = room_masks(r, 64)
    args = (rooms["grid"], instr_jax(instr), rooms["agent_pos"], rooms["agent_dir"],
            mask)
    want = jit_integer(JV.init_verifier_state, *args)(*args)
    got = V.init_verifier_state(torch.from_numpy(rooms["grid"].astype(np.int32)),
                                {f: torch.from_numpy(v) for f, v in instr.items()},
                                torch.from_numpy(rooms["agent_pos"]),
                                torch.from_numpy(rooms["agent_dir"]),
                                torch.from_numpy(mask))
    assert_tree_equal(port_numpy(got), _numpy_tree(want), "init: ")


# -- the step ------------------------------------------------------------------------

def _start(r: np.random.Generator, k: int):
    rooms = random_rooms(r, B)
    instr = random_instr(r, rooms["grid"], k, faced_objects(rooms))
    fields = {**rooms, "box_contains": None, "carrying_contains": None,
              "step_count": np.zeros(B, np.int32), "terminated": np.zeros(B, bool),
              "truncated": np.zeros(B, bool),
              "rng": np.zeros((B, 2), np.uint32), "mission": np.zeros((B, 4), np.int32),
              "max_steps": np.zeros(B, np.int32)}
    return fields, instr, room_masks(r, B)


def _step_program(done: bool, example: tuple):
    params = JEnvParams(width=W, height=H, max_steps=1000)

    def one(state, instr, vs, action):
        state, _, _, _, outcome = j_base_step(state, action, params)
        vs, status = JV.verify_step(vs, instr, state.grid, state.agent_pos,
                                    state.agent_dir, action, outcome, done_actions=done)
        return state, vs, status

    return jit_integer(one, *example)


@pytest.mark.parametrize("done_actions", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_verify_step_matches_jax(k, done_actions):
    r = np.random.default_rng(10 * k + done_actions)
    fields, instr, mask = _start(r, k)
    jstate = _jax_state(fields)
    jinstr = instr_jax(instr)
    jvs = jax.vmap(JV.init_verifier_state)(jstate.grid, jinstr, jstate.agent_pos,
                                           jstate.agent_dir, jnp.asarray(mask))
    state = state_from_numpy(fields, CPU)
    tinstr = {f: torch.from_numpy(v) for f, v in instr.items()}
    vs = V.init_verifier_state(state.grid, tinstr, state.agent_pos, state.agent_dir,
                               torch.from_numpy(mask))
    params = EnvParams(width=W, height=H, max_steps=1000, babyai_done_actions=done_actions)
    actions = r.choice(_ACTIONS, (STEPS, B), p=_ACTION_P).astype(np.int32)
    if done_actions:
        # `done` right after a step that may have matched
        odd = actions[1::2]
        odd[r.random(odd.shape) < 0.5] = 6
    program = _step_program(done_actions, (jstate, jinstr, jvs, jnp.asarray(actions[0])))
    seen = {}
    for t in range(STEPS):
        a = actions[t]
        jstate, jvs, jstatus = program(jstate, jinstr, jvs, jnp.asarray(a))
        state, _, _, _, outcome = base_step(state, torch.from_numpy(a), params)
        vs, status = V.verify_step(vs, tinstr, state.grid, state.agent_pos,
                                   state.agent_dir, torch.from_numpy(a), outcome,
                                   done_actions=done_actions)
        where = f"step {t}: "
        np.testing.assert_array_equal(state.grid.numpy().astype(np.uint32),
                                      np.asarray(jstate.grid), err_msg=where + "grid")
        assert status.dtype == torch.int32
        np.testing.assert_array_equal(status.numpy(), np.asarray(jstatus),
                                      err_msg=where + "status")
        assert_tree_equal(port_numpy(vs), _numpy_tree(jvs), where)
        st = status.numpy()
        for b in np.flatnonzero(st != V.CONTINUE):
            key = (int(instr["seq_kind"][b]) if k == 4 else int(instr["kinds"][b, 0]))
            seen.setdefault(key, set()).add(int(st[b]))
    # every clause kind (one-clause codes) and every sequencing kind (four
    # slots) both succeeded and failed somewhere
    wanted = ([V.K_GOTO, V.K_PICKUP, V.K_OPEN, V.K_PUTNEXT] if k == 1
              else [V.S_SINGLE, V.S_BEFORE, V.S_AFTER, V.S_AND])
    for key in wanted:
        if not done_actions and key == (V.K_GOTO if k == 1 else V.S_AND):
            # GoTo and a top-level And cannot fail but through `done`
            assert seen.get(key) == {V.SUCCESS}, (key, seen.get(key))
            continue
        assert seen.get(key) == {V.SUCCESS, V.FAILURE}, (key, seen.get(key))


# -- PutNext validation --------------------------------------------------------

def test_putnext_valid_matches_jax():
    """Move and fixed descs naming the same object (shared), two objects
    side by side (adjacent), two apart (valid), and a non-PutNext clause on
    a shared set (valid)."""
    env_id = "BabyAI-GoToRedBall-v0"
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    p, jp = env.default_params, jenv.default_params
    w, h = p.width, p.height
    ball = C.OBJECT_TO_IDX["ball"] | (C.COLOR_TO_IDX["red"] << 8)
    key = C.OBJECT_TO_IDX["key"] | (C.COLOR_TO_IDX["blue"] << 8)
    cases = [((2, 2), (5, 5), V.K_PUTNEXT, True),   # apart
             ((2, 2), (2, 3), V.K_PUTNEXT, False),  # adjacent, same column
             ((3, 4), (4, 4), V.K_PUTNEXT, False),  # adjacent, same row
             ((3, 3), (4, 4), V.K_PUTNEXT, True),   # diagonal is not adjacent
             ((2, 2), None, V.K_PUTNEXT, False),    # shared: both name the ball
             ((2, 2), None, V.K_GOTO, True)]        # shared, but no PutNext
    n = len(cases)
    grid = np.full((n, w, h), C.OBJECT_TO_IDX["empty"], np.uint32)
    instr = random_instr(np.random.default_rng(0), np.full((n, w, h), ball, np.uint32), 1)
    for i, (a, b, kind, _) in enumerate(cases):
        grid[i][a] = ball
        instr["kinds"][i, 0] = kind
        instr["d1"][i, 0] = (2, C.COLOR_TO_IDX["red"], 0)
        if b is None:
            instr["d2"][i, 0] = (2, 0, 0)
        else:
            grid[i][b] = key
            instr["d2"][i, 0] = (3, C.COLOR_TO_IDX["blue"], 0)
    pos = np.ones((n, 2), np.int32)
    direction = np.zeros(n, np.int32)

    def one(g, ins, ps, d):
        return jenv.putnext_valid({"grid": g}, ins, jp, ps, d)

    args = (grid, instr_jax(instr), pos, direction)
    want = np.asarray(jit_integer(one, *args)(*args))
    got = env.putnext_valid({"grid": torch.from_numpy(grid.astype(np.int32))},
                            {f: torch.from_numpy(v) for f, v in instr.items()}, p,
                            torch.from_numpy(pos), torch.from_numpy(direction))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [c[-1] for c in cases])
