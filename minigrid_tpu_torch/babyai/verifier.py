"""BabyAI instruction language: the tensor verifier, batch-first.

Counterpart of ``minigrid_tpu/babyai/verifier.py``.  An instruction (ObjDesc
matchers in GoTo/Pickup/Open/PutNext clauses, composed by Before/After/And)
is a fixed-size code of at most four clauses:

    seq_kind: 0 single clause, 1 before, 2 after, 3 and
    a_and / b_and: the operand is an And of two clauses
    clauses 0-1 are operand a, clauses 2-3 operand b

Where the JAX package keeps one env's code and tracking state as flax
dataclasses and vmaps, the port keeps both as dicts of ``[B, ...]`` tensors
keyed by the JAX field names, so the batch engine's selects and ring copies
carry them like any other field:

* instruction code: ``seq_kind`` int32[B], ``a_and``/``b_and`` bool[B],
  ``kinds`` int32[B, K], ``d1``/``d2`` int32[B, K, 3] (local type, color id
  or 0 for any, location), ``strict`` bool[B, K];
* verifier state: ``tracked1``/``tracked2``/``stale1``/``stale2`` packed
  planes int64[B, K, W] (bit y of word x is cell (x, y); the JAX package's
  uint32 words, which torch cannot hold unsigned), ``carry1``, ``carry2``,
  ``pre_empty``, ``pre_carry1``, ``last_match`` bool[B, K], and the packed
  operand statuses ``a_packed``/``b_packed`` int32[B] (status + 4 * first
  clause done + 8 * second clause done).

A single-clause family carries K = 1 and ``verify_step`` takes the
one-clause path; composite codes have K = 4.  Objects move only through the
agent's pickup and drop, so identity tracking is two one-cell updates a step;
the verify-visible planes (``stale*``) refresh only on drop actions, as the
reference's ``update_objs_poss`` does.  ``done_actions`` is the reference's
BABYAI_DONE_ACTIONS mode.

Tracing (``utils/trace.py``) sees the composite path's three stages as the
spans ``babyai.track`` (:func:`_update_tracking`), ``babyai.clauses``
(:func:`_eval_clauses`) and ``babyai.sequence`` (the operands' And and the
Before/After/And state machines); the one-clause path records none of them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import const, read_word
from minigrid_tpu_torch.core.step import DONE, DROP, PICKUP, TOGGLE, StepOutcome, dir_to_vec
from minigrid_tpu_torch.utils import trace

# Instruction clause kinds
K_NONE, K_GOTO, K_PICKUP, K_OPEN, K_PUTNEXT = range(5)
# Sequencing kinds
S_SINGLE, S_BEFORE, S_AFTER, S_AND = range(4)
# Statuses
CONTINUE, SUCCESS, FAILURE = 0, 1, 2

# Describable object types, language-local ids 1..4 (0: any 'object')
OBJ_TYPES = ["box", "ball", "key", "door"]
OBJ_TYPES_NOT_DOOR = ["box", "ball", "key"]
LOC_NAMES = ["left", "right", "front", "behind"]
# desc.type (local) -> world type id
DESC_TYPE_IDS = np.asarray([0] + [C.OBJECT_TO_IDX[t] for t in OBJ_TYPES],
                           dtype=np.int32)
# desc.loc: 0 none, 1 left, 2 right, 3 front, 4 behind

_DOOR = C.OBJECT_TO_IDX["door"]
_EMPTY = C.OBJECT_TO_IDX["empty"]
_OPEN = C.STATE_TO_IDX["open"]


def _batch(v, n: int, device, dtype=torch.int32) -> torch.Tensor:
    """A Python value or a tensor of one value per env -> ``dtype[n]``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).expand(n)
    return torch.full((n,), v, dtype=dtype, device=device)


# -- packed planes ---------------------------------------------------------------

def pack_planes(m: torch.Tensor) -> torch.Tensor:
    """bool[..., W, H] -> int64[..., W]: bit y of word [..., x] is cell
    (x, y).  Raises ``ValueError`` above H = 32, where the JAX package's
    uint32 word would overflow."""
    h = m.shape[-1]
    if h > 32:
        raise ValueError(f"packed verifier planes require grid height <= 32, got {h}")
    weights = torch.ones((), dtype=torch.int64, device=m.device) << torch.arange(
        h, dtype=torch.int64, device=m.device)
    return torch.where(m, weights, torch.zeros_like(weights)).sum(dim=-1)


def unpack_planes(p: torch.Tensor, h: int) -> torch.Tensor:
    """int64[..., W] -> bool[..., W, H] (the inverse of :func:`pack_planes`)."""
    shifts = torch.arange(h, dtype=torch.int64, device=p.device)
    return ((p[..., None] >> shifts) & 1) > 0


def onehot_packed(w: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int64[B, W] one-hot plane of cell (x[b], y[b]) in the packed layout."""
    xs = torch.arange(w, dtype=torch.int32, device=x.device)
    bit = torch.ones_like(y, dtype=torch.int64) << y.to(torch.int64)
    return torch.where(xs == x[:, None], bit[:, None], torch.zeros_like(bit)[:, None])


# -- instruction constructors --------------------------------------------------

def desc(type_id, color_id=0, loc=0, n: int | None = None, device=None) -> torch.Tensor:
    """int32[B, 3] descs from a *world* type id (box/ball/key/door, or 0 for
    'object'), a color id (0: any) and a location; each a Python value or one
    per env.  ``n``/``device`` give the batch when every argument is a
    Python value."""
    like = next((v for v in (type_id, color_id, loc) if isinstance(v, torch.Tensor)),
                None)
    if like is not None:
        n, device = like.shape[0], like.device
    t = _batch(type_id, n, device)
    local = torch.zeros_like(t)
    for i, name in enumerate(OBJ_TYPES):
        local = torch.where(t == C.OBJECT_TO_IDX[name], i + 1, local)
    return torch.stack([local, _batch(color_id, n, device), _batch(loc, n, device)],
                       dim=1)


def empty_instr(n: int, device, k: int = 4) -> dict:
    return {
        "seq_kind": torch.full((n,), S_SINGLE, dtype=torch.int32, device=device),
        "a_and": torch.zeros((n,), dtype=torch.bool, device=device),
        "b_and": torch.zeros((n,), dtype=torch.bool, device=device),
        "kinds": torch.zeros((n, k), dtype=torch.int32, device=device),
        "d1": torch.zeros((n, k, 3), dtype=torch.int32, device=device),
        "d2": torch.zeros((n, k, 3), dtype=torch.int32, device=device),
        "strict": torch.zeros((n, k), dtype=torch.bool, device=device),
    }


def single_clause(kind, d1: torch.Tensor, d2: torch.Tensor | None = None,
                  strict=False, k: int = 1) -> dict:
    """The code of one action clause in slot 0 of ``k`` slots; ``d1`` (and
    ``d2``) int32[B, 3], ``kind`` and ``strict`` a value or one per env.  A
    single-clause family keeps ``k = 1``, so its verifier takes the
    one-clause path; composite codes have 4 slots."""
    n, dev = d1.shape[0], d1.device
    x = empty_instr(n, dev, k)
    x["kinds"][:, 0] = _batch(kind, n, dev)
    x["d1"][:, 0] = d1.to(torch.int32)
    if d2 is not None:
        x["d2"][:, 0] = d2.to(torch.int32)
    x["strict"][:, 0] = _batch(strict, n, dev, torch.bool)
    return x


def pad_clauses(x: dict, k: int = 4) -> dict:
    """Zero-pad a code to ``k`` clause slots (K_NONE clauses are inert)."""
    have = x["kinds"].shape[1]
    if have >= k:
        return x
    p = k - have

    def pad(t):
        return torch.cat([t, t.new_zeros((t.shape[0], p) + t.shape[2:])], dim=1)

    return {**x, **{f: pad(x[f]) for f in ("kinds", "d1", "d2", "strict")}}


def and_instr(a: dict, b: dict) -> dict:
    """AndInstr(a, b) of two single clauses: slots 0 and 2."""
    n, dev = a["kinds"].shape[0], a["kinds"].device
    x = empty_instr(n, dev)
    x["seq_kind"] = torch.full((n,), S_AND, dtype=torch.int32, device=dev)
    for slot, src in ((0, a), (2, b)):
        for f in ("kinds", "d1", "d2", "strict"):
            x[f][:, slot] = src[f][:, 0]
    return x


def seq_instr(seq_kind, a: dict, b: dict) -> dict:
    """Before/After(a, b) of single or And codes: an And operand fills both
    slots of its half, a single one the first.  ``seq_kind`` is a value or
    one per env."""
    a, b = pad_clauses(a), pad_clauses(b)
    n, dev = a["kinds"].shape[0], a["kinds"].device

    def half(x):
        is_and = x["seq_kind"] == S_AND
        out = {}
        for f in ("kinds", "d1", "d2", "strict"):
            second = x[f][:, 2]
            keep = is_and.view((-1,) + (1,) * (second.dim() - 1))
            out[f] = torch.stack([x[f][:, 0],
                                  torch.where(keep, second, torch.zeros_like(second))],
                                 dim=1)
        return is_and, out

    a_is_and, ah = half(a)
    b_is_and, bh = half(b)
    return {"seq_kind": _batch(seq_kind, n, dev), "a_and": a_is_and, "b_and": b_is_and,
            **{f: torch.cat([ah[f], bh[f]], dim=1) for f in ah}}


# -- reset-time matching -------------------------------------------------------

def desc_match_mask(grid: torch.Tensor, desc: torch.Tensor, agent_pos: torch.Tensor,
                    agent_dir: torch.Tensor, room_mask: torch.Tensor | None
                    ) -> torch.Tensor:
    """ObjDesc.find_matching_objs at reset: the cells of each env's grid
    int32[B, W, H] that match its desc (type, color, location), bool
    ``[B, W, H]`` for a desc int32[B, 3] or ``[B, M, W, H]`` for M descs
    ``[B, M, 3]``.  Locations are relative to the agent's starting pose and,
    with ``room_mask`` bool[B, W, H], restricted to its starting room."""
    many = desc.dim() == 3
    d = desc if many else desc[:, None]
    t_local, color, loc = (d[..., i, None, None] for i in range(3))  # [B, M, 1, 1]
    g = grid[:, None]
    types = g & 0xFF
    colors = (g >> 8) & 0xFF
    is_desc_obj = ((types == C.OBJECT_TO_IDX["box"]) | (types == C.OBJECT_TO_IDX["ball"])
                   | (types == C.OBJECT_TO_IDX["key"]) | (types == _DOOR))
    table = const(DESC_TYPE_IDS, grid.device, torch.int32)
    want_type = table[t_local.clamp(0, len(DESC_TYPE_IDS) - 1).to(torch.int64)]
    m = torch.where(t_local == 0, is_desc_obj, types == want_type)
    m = m & ((color == 0) | (colors == color))

    _, w, h = grid.shape
    xs = torch.arange(w, dtype=torch.int32, device=grid.device)[:, None]
    ys = torch.arange(h, dtype=torch.int32, device=grid.device)[None, :]
    vx = xs - agent_pos[:, 0, None, None, None]
    vy = ys - agent_pos[:, 1, None, None, None]
    f0, f1 = (v[:, None, None, None] for v in dir_to_vec(agent_dir))
    dot_d1 = vx * f0 + vy * f1
    dot_d2 = vx * (-f1) + vy * f0
    loc_ok = torch.where(
        loc == 1, dot_d2 < 0,
        torch.where(loc == 2, dot_d2 > 0,
                    torch.where(loc == 3, dot_d1 > 0,
                                torch.where(loc == 4, dot_d1 < 0, True))))
    if room_mask is not None:
        loc_ok = loc_ok & room_mask[:, None]
    m = m & ((loc == 0) | loc_ok)
    return m if many else m[:, 0]


def init_verifier_state(grid: torch.Tensor, instr: dict, agent_pos: torch.Tensor,
                        agent_dir: torch.Tensor, room_mask: torch.Tensor | None,
                        masks: tuple[torch.Tensor, torch.Tensor] | None = None) -> dict:
    """The verifier state at reset, every clause reset.  ``masks`` passes
    precomputed (tracked1, tracked2) desc-match planes bool[B, K, W, H]."""
    n, k = instr["kinds"].shape
    if masks is None:
        masks = tuple(desc_match_mask(grid, instr[f], agent_pos, agent_dir, room_mask)
                      for f in ("d1", "d2"))
    tracked1, tracked2 = (pack_planes(m) for m in masks)
    dev = grid.device

    def flags(value):
        return torch.full((n, k), value, dtype=torch.bool, device=dev)

    def status():
        return torch.full((n,), CONTINUE, dtype=torch.int32, device=dev)

    return {
        "tracked1": tracked1, "tracked2": tracked2,
        "stale1": tracked1.clone(), "stale2": tracked2.clone(),
        "carry1": flags(False), "carry2": flags(False),
        "pre_empty": flags(True),  # preCarrying = None at reset
        "pre_carry1": flags(False), "last_match": flags(False),
        "a_packed": status(), "b_packed": status(),
    }


# -- the step -------------------------------------------------------------------

def _update_tracking(vs: dict, outcome: StepOutcome, action: torch.Tensor,
                     h: int) -> dict:
    """Follow the objects the agent picks up and drops; refresh the
    verify-visible planes on drop actions."""
    w = vs["tracked1"].shape[-1]
    fx = outcome.fwd_pos[:, 0].clamp(0, w - 1)
    fy = outcome.fwd_pos[:, 1].clamp(0, h - 1)
    front = onehot_packed(w, fx, fy)[:, None]  # [B, 1, W]
    picked = outcome.picked_up[:, None]
    dropped = outcome.dropped[:, None]

    def upd(tracked, carry):
        was = ((tracked & front) != 0).any(dim=-1)
        new_carry = torch.where(picked, was, carry)
        cell = was & ~picked
        cell = cell | (dropped & new_carry)
        tracked = torch.where(cell[..., None], tracked | front, tracked & ~front)
        return tracked, new_carry & ~dropped

    tracked1, carry1 = upd(vs["tracked1"], vs["carry1"])
    # desc2 (PutNext's fixed) objects move too: their carry flag puts the
    # bit back at the drop cell
    tracked2, carry2 = upd(vs["tracked2"], vs["carry2"])
    refresh = (action == DROP)[:, None, None]
    return {**vs, "tracked1": tracked1, "tracked2": tracked2,
            "stale1": torch.where(refresh, tracked1, vs["stale1"]),
            "stale2": torch.where(refresh, tracked2, vs["stale2"]),
            "carry1": carry1, "carry2": carry2}


def _eval_clauses(vs: dict, instr: dict, grid: torch.Tensor, agent_pos: torch.Tensor,
                  agent_dir: torch.Tensor, action: torch.Tensor,
                  outcome: StepOutcome) -> torch.Tensor:
    """Each clause's raw verify_action result this step: int32[B, K]."""
    _, w, h = grid.shape
    fdx, fdy = dir_to_vec(agent_dir)
    fwd_x, fwd_y = agent_pos[:, 0] + fdx, agent_pos[:, 1] + fdy
    in_b = (fwd_x >= 0) & (fwd_x < w) & (fwd_y >= 0) & (fwd_y < h)
    fx, fy = fwd_x.clamp(0, w - 1), fwd_y.clamp(0, h - 1)
    fwd_word = read_word(grid, fx, fy)
    fwd_is_door = ((fwd_word & 0xFF) == _DOOR) & in_b
    fwd_open = ((fwd_word >> 16) & 0xFF) == _OPEN
    empty_before = outcome.prev_carrying[:, 0].to(torch.int32) == _EMPTY
    carrying_after = (~empty_before & ~outcome.dropped) | outcome.picked_up
    # the drop cell's 4-neighbourhood on the packed layout: the bits beside
    # it in its own column, the same bit in the columns beside it
    dx = outcome.fwd_pos[:, 0].clamp(0, w - 1)
    dy = outcome.fwd_pos[:, 1].clamp(0, h - 1)
    xs = torch.arange(w, dtype=torch.int32, device=grid.device)
    dbit = (torch.ones_like(dy, dtype=torch.int64) << dy.to(torch.int64))[:, None]
    zero = torch.zeros_like(dbit)
    adj_p = (torch.where(xs == dx[:, None], (dbit << 1) | (dbit >> 1), zero)
             | torch.where((xs - dx[:, None]).abs() == 1, dbit, zero))[:, None]
    front_p = onehot_packed(w, fx, fy)[:, None]
    stale1_at_front = ((vs["stale1"] & front_p) != 0).any(dim=-1)
    tracked1_at_front = ((vs["tracked1"] & front_p) != 0).any(dim=-1)
    stale2_adj = ((vs["stale2"] & adj_p) != 0).any(dim=-1)

    kind, strict = instr["kinds"], instr["strict"]
    is_toggle = (action == TOGGLE)[:, None]
    is_pickup = (action == PICKUP)[:, None]
    goto_succ = stale1_at_front & in_b[:, None]
    open_succ = is_toggle & tracked1_at_front & (fwd_is_door & fwd_open)[:, None]
    open_fail = is_toggle & strict & fwd_is_door[:, None] & ~open_succ
    pickup_succ = is_pickup & vs["pre_empty"] & vs["carry1"]
    pickup_fail = is_pickup & strict & carrying_after[:, None] & ~pickup_succ
    putnext_succ = (((action == DROP) & outcome.dropped)[:, None] & vs["pre_carry1"]
                    & stale2_adj)
    putnext_fail = is_pickup & strict & carrying_after[:, None]

    res = torch.full_like(kind, CONTINUE)
    for k_id, succ, fail in ((K_GOTO, goto_succ, None), (K_OPEN, open_succ, open_fail),
                             (K_PICKUP, pickup_succ, pickup_fail),
                             (K_PUTNEXT, putnext_succ, putnext_fail)):
        res = torch.where((kind == k_id) & succ, SUCCESS, res)
        if fail is not None:
            res = torch.where((kind == k_id) & fail & (res == CONTINUE), FAILURE, res)
    return res


def _unpack(p: torch.Tensor):
    return p % 4, (p // 4) % 2 == 1, (p // 8) % 2 == 1


def _pack(status: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return status + 4 * c0.to(torch.int32) + 8 * c1.to(torch.int32)


def _status(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, v, dtype=torch.int32)


def verify_step(vs: dict, instr: dict, grid: torch.Tensor, agent_pos: torch.Tensor,
                agent_dir: torch.Tensor, action: torch.Tensor, outcome: StepOutcome,
                done_actions: bool = False) -> tuple[dict, torch.Tensor]:
    """One verifier tick after the transition: (new state, status int32[B]
    of CONTINUE / SUCCESS / FAILURE).

    With ``done_actions`` a clause succeeds only through a ``done`` action
    taken while its condition matched on the previous step, a ``done``
    without a match fails, and no other action ends the episode."""
    action = action.to(torch.int32)
    composite = instr["kinds"].shape[1] > 1
    # the one-clause path records no span: a no-op context that takes the name
    stage = trace.span if composite else contextlib.nullcontext
    with stage("babyai.track"):
        vs = _update_tracking(vs, outcome, action, grid.shape[2])
    with stage("babyai.clauses"):
        raw = _eval_clauses(vs, instr, grid, agent_pos, agent_dir, action, outcome)
    is_done_act = action == DONE
    raw_match = raw == SUCCESS
    if done_actions:
        raw = torch.where(is_done_act[:, None],
                          torch.where(vs["last_match"], SUCCESS, FAILURE),
                          CONTINUE).to(torch.int32)
    empty_before = outcome.prev_carrying[:, 0].to(torch.int32) == _EMPTY
    hands_empty_after = (empty_before & ~outcome.picked_up) | outcome.dropped

    if not composite:
        # a single-clause family: the clause's raw result is the status
        last_match = vs["last_match"]
        if done_actions:
            last_match = torch.where(~is_done_act[:, None], raw_match, last_match)
        return ({**vs, "pre_empty": hands_empty_after[:, None],
                 "pre_carry1": vs["carry1"], "last_match": last_match}, raw[:, 0])
    with trace.span("babyai.sequence"):
        return _sequence(vs, instr, raw, raw_match, is_done_act, hands_empty_after,
                         done_actions)


def _sequence(vs: dict, instr: dict, raw: torch.Tensor, raw_match: torch.Tensor,
              is_done_act: torch.Tensor, hands_empty_after: torch.Tensor,
              done_actions: bool) -> tuple[dict, torch.Tensor]:
    """The composite path after the clauses: each operand's And, the
    Before/After/And state machines, and the clause-local snapshots of the
    clauses they evaluated."""
    a_stat, a_c0, a_c1 = _unpack(vs["a_packed"])
    b_stat, b_c0, b_c1 = _unpack(vs["b_packed"])

    def operand(base, is_and, c0_done, c1_done):
        """AndInstr.verify of the operand's two clauses, or its one clause."""
        r0 = torch.where(c0_done, SUCCESS, raw[:, base])
        r1 = torch.where(c1_done, SUCCESS, raw[:, base + 1])
        and_res = torch.where((r0 == SUCCESS) & (r1 == SUCCESS), SUCCESS, _status(
            CONTINUE, r0))
        if done_actions:
            and_res = torch.where(is_done_act & (r0 == FAILURE) & (r1 == FAILURE),
                                  FAILURE, and_res)
        return (torch.where(is_and, and_res, raw[:, base]), r0 == SUCCESS,
                r1 == SUCCESS)

    a_res, a_c0n, a_c1n = operand(0, instr["a_and"], a_c0, a_c1)
    b_res, b_c0n, b_c1n = operand(2, instr["b_and"], b_c0, b_c1)
    seq = instr["seq_kind"]
    cont = _status(CONTINUE, a_res)

    # top-level And: operand successes lock across steps
    a_eff = torch.where(a_stat == SUCCESS, SUCCESS, a_res)
    b_eff = torch.where(b_stat == SUCCESS, SUCCESS, b_res)
    and_status = torch.where((a_eff == SUCCESS) & (b_eff == SUCCESS), SUCCESS, cont)
    if done_actions:
        and_status = torch.where(is_done_act & (a_eff == FAILURE) & (b_eff == FAILURE),
                                 FAILURE, and_status)

    # Before
    a_done = a_stat == SUCCESS
    bef_a_new = torch.where(a_done, a_stat, a_res)
    bef_b_active = a_done | (bef_a_new == SUCCESS)
    bef_b_new = torch.where(bef_b_active, b_res, b_stat)
    before_status = torch.where(
        (~a_done & (bef_a_new == FAILURE)) | (bef_b_active & (bef_b_new == FAILURE)),
        FAILURE, torch.where(bef_b_active & (bef_b_new == SUCCESS), SUCCESS, cont))

    # After: the mirror
    b_done = b_stat == SUCCESS
    aft_b_new = torch.where(b_done, b_stat, b_res)
    aft_a_active = b_done | (aft_b_new == SUCCESS)
    aft_a_new = torch.where(aft_a_active, a_res, a_stat)
    after_status = torch.where(
        (~b_done & (aft_b_new == FAILURE)) | (aft_a_active & (aft_a_new == FAILURE)),
        FAILURE, torch.where(aft_a_active & (aft_a_new == SUCCESS), SUCCESS, cont))

    is_before, is_after, is_and = seq == S_BEFORE, seq == S_AFTER, seq == S_AND
    status = torch.where(seq == S_SINGLE, a_res,
                         torch.where(is_before, before_status,
                                     torch.where(is_after, after_status, and_status)))

    # which clauses the reference evaluated this step
    a_active = torch.where(is_before, ~a_done,
                           torch.where(is_after, aft_a_active,
                                       torch.where(is_and, a_stat != SUCCESS, True)))
    b_active = torch.where(is_before, bef_b_active,
                           torch.where(is_after, ~b_done,
                                       torch.where(is_and, b_stat != SUCCESS, False)))

    new_a_stat = torch.where(is_before, bef_a_new, torch.where(
        is_after, aft_a_new, torch.where(a_active & (a_res == SUCCESS), SUCCESS, a_stat)))
    new_b_stat = torch.where(is_before, bef_b_new, torch.where(
        is_after, aft_b_new, torch.where(b_active & (b_res == SUCCESS), SUCCESS, b_stat)))
    new_a = _pack(new_a_stat, torch.where(a_active, a_c0n, a_c0),
                  torch.where(a_active, a_c1n, a_c1))
    new_b = _pack(new_b_stat, torch.where(b_active, b_c0n, b_c0),
                  torch.where(b_active, b_c1n, b_c1))

    # clause-local preCarrying snapshots, where the clause was evaluated
    clause_active = torch.stack([a_active, a_active & instr["a_and"],
                                 b_active, b_active & instr["b_and"]], dim=1)
    new_pre_empty = torch.where(clause_active, hands_empty_after[:, None],
                                vs["pre_empty"])
    new_pre_carry1 = torch.where(clause_active, vs["carry1"], vs["pre_carry1"])
    last_match = vs["last_match"]
    if done_actions:
        last_match = torch.where(clause_active & ~is_done_act[:, None], raw_match,
                                 last_match)
    return ({**vs, "a_packed": new_a.to(torch.int32), "b_packed": new_b.to(torch.int32),
             "pre_empty": new_pre_empty, "pre_carry1": new_pre_carry1,
             "last_match": last_match}, status.to(torch.int32))


def num_navs(instr: dict) -> torch.Tensor:
    """num_navs_needed: PutNext counts 2, the other clauses 1; int32[B]."""
    kinds = instr["kinds"]
    per_clause = torch.where(kinds == K_PUTNEXT, 2, torch.where(kinds == K_NONE, 0, 1))
    return per_clause.sum(dim=1, dtype=torch.int32)
