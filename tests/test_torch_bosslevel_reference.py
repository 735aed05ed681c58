"""BabyAI BossLevel in the port against the benchmark's plain NumPy
reference (``perfbench/reference/babyai_full.py`` and
``perfbench/reference/tasks/babyai_bosslevel.py``), on the CPU: LevelGen's
levels made again from their keys at a reset and at a refill, a random walk
of the pooled engine through its auto-resets, and hand-built transitions in
which each clause kind succeeds and in which two operands are done in the
wrong order under each of the four sequencing kinds.  Every field of the
state, the instruction code, the mission and the whole verifier state is
compared.  Nothing here imports JAX.

    python -m pytest tests/test_torch_bosslevel_reference.py -q
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import flatten_instr
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run as R  # noqa: E402
from perfbench.drivers.vector_random import Driver  # noqa: E402
from perfbench.harness import state as S  # noqa: E402
from perfbench.reference import babyai_full as BF  # noqa: E402
from perfbench.reference import minigrid as M  # noqa: E402
from perfbench.reference.roomgrid import Lattice  # noqa: E402
from perfbench.reference.tasks import babyai_bosslevel as T  # noqa: E402

CPU = torch.device("cpu")
CELL = "babyai-bosslevel.pooled-random"
_, _, CFG, WORKLOAD = R.load_cell(CELL)
ENV = mgt.make(CFG["env_id"], **CFG["env_kwargs"])
PARAMS = ENV.default_params
RESET_KEYS = np.stack([np.full(24, 3_000_000_019 >> 32), np.arange(24) * 7919 + 11], 1)
ATTEMPT_KEYS = np.stack([np.full(32, 17), np.arange(32) * 104_729 + 3], 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Under pytest-xdist, torch on one thread beside the other workers."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _differing(ref: dict, prog: dict) -> list[str]:
    """The fields (paths) in which two level dicts differ in any row."""
    out = []

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif S.rows_differ(a, b).any():
            out.append(path)

    walk(ref, prog, "")
    return out


# -- (a) and (b): levels made again from their keys -----------------------------------

def test_reset_levels_match_reference():
    prog = ENV.generate(torch.tensor(RESET_KEYS), PARAMS, CPU)
    ref = T.generate(RESET_KEYS, CFG)
    assert _differing(T.modelled(ref), T.modelled(S.env_levels(prog))) == []
    assert (S.to_np(prog.mission) == ref["mission"]).all()


def test_attempt_levels_and_valid_flags_match_reference():
    cand, ok = ENV.generate_attempt(torch.tensor(ATTEMPT_KEYS), PARAMS, CPU)
    drawn, valid = T.attempt(ATTEMPT_KEYS, CFG)
    assert (S.to_np(ok) == valid).all() and 0 < valid.sum() < valid.size
    assert _differing(T.modelled(drawn), T.modelled(S.env_levels(cand))) == []


def test_levels_compared_cover_the_grammar():
    """Across the levels of the two tests above: every instruction shape
    (single, Before, After, And), an And operand, every clause kind, a
    located description and a locked room."""
    levels = [T.generate(RESET_KEYS, CFG), T.attempt(ATTEMPT_KEYS, CFG)[0]]
    instr = {k: np.concatenate([lv["extra"]["instr"][k] for lv in levels])
             for k in ("seq_kind", "a_and", "b_and", "kinds", "d1", "d2")}
    grid = np.concatenate([lv["grid"] for lv in levels])
    assert set(instr["seq_kind"].tolist()) == {BF.S_SINGLE, BF.S_BEFORE, BF.S_AFTER, BF.S_AND}
    assert (instr["a_and"] | instr["b_and"]).any()
    assert {BF.K_GOTO, BF.K_PICKUP, BF.K_OPEN, BF.K_PUTNEXT} <= set(instr["kinds"].ravel().tolist())
    used = instr["kinds"] > 0
    assert (used & (instr["d1"][..., 2] > 0)).any()
    locked = (M.cell_type(grid) == M.DOOR_T) & (M.cell_state(grid) == M.LOCKED)
    assert locked.any((1, 2)).any() and not locked.any((1, 2)).all()


# -- (c): a random walk through the auto-resets --------------------------------------

def test_random_walk_through_auto_resets_matches_reference():
    """48 steps of the pooled engine at B=16, episodes cut to 12 steps, a
    refill of 8 windows every 8 steps: every step's state (the verifier's
    whole state included), observation, reward and flags, the ring's
    serves and refills, and the reset, held against the reference."""
    cfg = {**CFG, "env_kwargs": {**CFG["env_kwargs"], "max_steps": 12}}
    wl = {**WORKLOAD, "num_envs": 16, "pool_refill": 2, "refill_every": 8,
          "warmup_blocks": 0, "sample_cap": 6}
    drv = Driver(cfg, wl, 2**31 + 77, CPU)
    drv.setup()
    ends = 0
    for _ in range(6):
        drv.block(sample=True)
    for sample in drv.samples:
        ends += sum(int((s.term | s.trunc).sum()) for s in drv.restore(sample).steps)
    counts = drv.check()
    checks = counts.result()
    assert R.C.correct(checks), checks
    assert checks["compared"]["value"] == 48 * 16 and counts.failures() == 0
    assert ends >= 2 * 16


# -- (d): hand-built transitions -------------------------------------------------------

LAT = Lattice(8, 3, 3)
RED, BLUE, GREEN = M.RED, M.BLUE, M.GREEN


def _desc(t: int, color: int = 0, loc: int = 0) -> list[int]:
    """A description: local type (1 box, 2 ball, 3 key, 4 door), color,
    location."""
    return [t, color, loc]


def _instr(seq: int, clauses: dict, a_and=False, b_and=False) -> dict:
    """An instruction code: ``clauses`` maps a slot to (kind, d1, d2)."""
    code = {"seq_kind": np.array([seq]), "a_and": np.array([a_and]),
            "b_and": np.array([b_and]), "kinds": np.zeros((1, 4), np.int64),
            "d1": np.zeros((1, 4, 3), np.int64), "d2": np.zeros((1, 4, 3), np.int64),
            "strict": np.zeros((1, 4), bool)}
    for slot, (kind, d1, d2) in clauses.items():
        code["kinds"][0, slot] = kind
        code["d1"][0, slot] = d1
        code["d2"][0, slot] = d2
    return code


def _level(objects: dict, pos, direction: int, instr: dict):
    """A port state of one level on the bare lattice: ``objects`` maps a
    cell to a packed word; the verifier starts as the port's reset starts
    it."""
    fields = state_to_numpy(ENV.generate(torch.tensor(RESET_KEYS[:1]), PARAMS, CPU))
    grid = LAT.lattice[None].copy()
    for (x, y), word in objects.items():
        grid[0, x, y] = word
    t_instr = {k: torch.as_tensor(v) for k, v in instr.items()}
    t_instr = {k: v.to(torch.int32) if v.dtype == torch.int64 else v for k, v in t_instr.items()}
    g = torch.as_tensor(grid, dtype=torch.int32)
    p = torch.as_tensor([pos], dtype=torch.int32)
    d = torch.as_tensor([direction], dtype=torch.int32)
    room = ENV.agent_room_mask({"agent_pos": p}, PARAMS)
    vs = V.init_verifier_state(g, t_instr, p, d, room)
    masks = [V.desc_match_mask(g, t_instr[f], p, d, room) for f in ("d1", "d2")]
    plural = torch.cat([m.sum((2, 3)) > 1 for m in masks], dim=1)
    articles = torch.stack([plural[:, :4], plural[:, 4:]], dim=2).reshape(1, 8)
    fields.update(grid=grid, agent_pos=np.array([pos]), agent_dir=np.array([direction]),
                  max_steps=BF.num_navs_needed(instr["kinds"]) * 576,
                  mission=flatten_instr(t_instr, articles).numpy(),
                  extra={"instr": instr, "vs": {k: v.numpy() for k, v in vs.items()}})
    return state_from_numpy(fields, CPU)


def _walk(state, actions: list[int]) -> list[int]:
    """Step the port and the reference in lockstep from ``state`` until the
    episode ends; every field, the reward's bits and the flags compared.
    Returns the statuses' steps of success (1-based)."""
    ref = S.env_levels(state)
    room = T.agent_room(LAT, ref)
    m1 = BF.match_all(ref["grid"], ref["extra"]["instr"]["d1"], ref["pos"], ref["dir"], room)
    m2 = BF.match_all(ref["grid"], ref["extra"]["instr"]["d2"], ref["pos"], ref["dir"], room)
    assert _differing(BF.reset_verifier(m1, m2), ref["extra"]["vs"]) == []
    ended = []
    for t, a in enumerate(actions, 1):
        act = np.array([a])
        _, state, reward, term, trunc, _ = ENV.step(state, torch.tensor(act, dtype=torch.int32),
                                                    PARAMS)
        after, r_ref, t_ref, tr_ref, outcome = M.step(ref, act, PARAMS.max_steps)
        after, r_ref, t_ref = T.post_step(ref, after, act, outcome, r_ref, t_ref, CFG)
        ref = {**after, "terminated": t_ref, "truncated": tr_ref}
        assert _differing(T.modelled(ref), T.modelled(S.env_levels(state))) == [], t
        assert S.to_np(reward).view(np.int32)[0] == r_ref.view(np.int32)[0], t
        assert (S.to_np(term) == t_ref).all() and (S.to_np(trunc) == tr_ref).all(), t
        if t_ref[0]:
            ended.append(t)
            break
    return ended


L, R_, F, PICK, DROP, TOG = M.LEFT, M.RIGHT, M.FORWARD, M.PICKUP, M.DROP, M.TOGGLE
BALL, BOX, KEY, DOOR = 2, 1, 3, 4
CLAUSES = {
    # "go to the red ball in front of you"
    "goto": ({(11, 10): M.pack(M.BALL_T, RED)}, (9, 10), 0,
             {0: (BF.K_GOTO, _desc(BALL, RED, 3), _desc(0))}, [L, R_, F], 3),
    "pickup": ({(10, 10): M.pack(M.BALL_T, RED)}, (9, 10), 0,
               {0: (BF.K_PICKUP, _desc(BALL, RED), _desc(0))}, [M.STAY, PICK], 2),
    "open": ({(14, 10): M.pack(M.DOOR_T, BLUE, M.CLOSED)}, (13, 10), 0,
             {0: (BF.K_OPEN, _desc(DOOR, BLUE), _desc(0))}, [TOG], 1),
    # "put the red ball next to the blue box"
    "putnext": ({(10, 10): M.pack(M.BALL_T, RED), (12, 10): M.pack(M.BOX_T, BLUE)}, (9, 10), 0,
                {0: (BF.K_PUTNEXT, _desc(BALL, RED), _desc(BOX, BLUE))}, [PICK, F, DROP], 3),
}


@pytest.mark.parametrize("kind", sorted(CLAUSES))
def test_each_clause_kind_succeeds_as_in_reference(kind):
    objects, pos, direction, clauses, actions, when = CLAUSES[kind]
    state = _level(objects, pos, direction, _instr(BF.S_SINGLE, clauses))
    assert _walk(state, actions) == [when]


# a = "pick up the red ball" (ahead), b = "go to the blue box" (on the
# right) and, in a Before/After, "go to the green key" (on the left) with
# it: the actions do b's clauses first, then a, then b's again
ORDER_OBJECTS = {(10, 10): M.pack(M.BALL_T, RED), (9, 11): M.pack(M.BOX_T, BLUE),
                 (9, 9): M.pack(M.KEY_T, GREEN)}
ORDER_ACTIONS = [R_, L, L, R_, PICK, R_, L, L]
A = (BF.K_PICKUP, _desc(BALL, RED), _desc(0))
B0 = (BF.K_GOTO, _desc(BOX, BLUE), _desc(0))
B1 = (BF.K_GOTO, _desc(KEY, GREEN), _desc(0))
ORDERS = {
    "single": (_instr(BF.S_SINGLE, {0: A}), 5),
    "and": (_instr(BF.S_AND, {0: A, 2: B0}), 5),
    "before": (_instr(BF.S_BEFORE, {0: A, 2: B0, 3: B1}, b_and=True), 8),
    "after": (_instr(BF.S_AFTER, {0: A, 2: B0, 3: B1}, b_and=True), 5),
}


@pytest.mark.parametrize("seq", sorted(ORDERS))
def test_operands_in_the_wrong_order_as_in_reference(seq):
    instr, when = ORDERS[seq]
    state = _level(ORDER_OBJECTS, (9, 10), 0, instr)
    assert _walk(state, ORDER_ACTIONS) == [when]
