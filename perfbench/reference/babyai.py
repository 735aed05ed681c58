"""Plain NumPy reference of BabyAI's GoTo level (Chevalier-Boisvert et al.,
ICLR 2019; Minigrid's ``minigrid/envs/babyai/goto.py`` and
``core/verifier.py``): the GoTo instruction's verifier over a step, and the
cells a description matches (its levels are made in ``tasks/babyai_goto.py``).

The verifier follows ``GoToInstr.verify_action`` and ``RoomGridLevel.step``:
the instruction tracks the objects that matched its description at reset;
an object the agent picks up leaves the grid with the agent, one it drops
is tracked at the drop cell, one a toggle removes (an opened box) is gone;
the positions the instruction checks (``obj_poss``) are refreshed on every
drop action; the instruction succeeds when the cell in front of the agent,
after the step, is one of those positions.  Success ends the episode with
the goal reward of the step.

A level's tracked and checked positions are boolean planes [B, W, H]; the
configuration keeps them packed, bit y of word x of an int64 per column,
which :func:`unpack_planes` reads.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M

K_GOTO = 1
DESC_TYPES = {1: M.BOX_T, 2: M.BALL_T, 3: M.KEY_T, 4: M.DOOR_T}


def unpack_planes(words: np.ndarray, h: int) -> np.ndarray:
    """int64[..., W] words -> bool[..., W, H]."""
    return ((words[..., None] >> np.arange(h, dtype=np.int64)) & 1) == 1


def pack_planes(mask: np.ndarray) -> np.ndarray:
    h = mask.shape[-1]
    return (mask.astype(np.int64) << np.arange(h, dtype=np.int64)).sum(-1)


def goto_step(before: dict, after: dict, action: np.ndarray, outcome: dict,
              tracked: np.ndarray, checked: np.ndarray, carry: np.ndarray):
    """The verifier over one transition ``before`` -> ``after`` (states of
    the minigrid reference): (success bool[B], tracked, checked, carry)."""
    b, w, h = after["grid"].shape
    rows = np.arange(b)
    tracked = tracked.copy()
    checked = checked.copy()
    carry = carry.copy()
    fwd = outcome["fwd"]
    inb = (fwd[:, 0] >= 0) & (fwd[:, 0] < w) & (fwd[:, 1] >= 0) & (fwd[:, 1] < h)
    fx, fy = np.clip(fwd[:, 0], 0, w - 1), np.clip(fwd[:, 1], 0, h - 1)
    at_front = tracked[rows, fx, fy] & inb
    picked, dropped = outcome["picked"], outcome["dropped"]
    # a tracked object picked up travels with the agent
    carry = np.where(picked, at_front, carry)
    # a tracked object stays tracked where it still stands: a toggle that
    # replaced it (an opened box) removes it
    gone = at_front & (picked | (M.cell_type(after["grid"][rows, fx, fy])
                                 != M.cell_type(before["grid"][rows, fx, fy])))
    tracked[rows[gone], fx[gone], fy[gone]] = False
    put = dropped & carry
    tracked[rows[put], fx[put], fy[put]] = True
    carry = carry & ~dropped
    refresh = action == M.DROP
    checked[refresh] = tracked[refresh]
    front = after["pos"] + M.DIR_TO_VEC[after["dir"]]
    inb2 = (front[:, 0] >= 0) & (front[:, 0] < w) & (front[:, 1] >= 0) & (front[:, 1] < h)
    success = inb2 & checked[rows, np.clip(front[:, 0], 0, w - 1),
                             np.clip(front[:, 1], 0, h - 1)]
    return success, tracked, checked, carry


def desc_mask(grid: np.ndarray, d1: np.ndarray) -> np.ndarray:
    """The cells that match each level's description (type, color, no
    location): bool[B, W, H]."""
    t = np.vectorize(lambda x: DESC_TYPES.get(int(x), -1))(d1[:, 0])
    return ((M.cell_type(grid) == t[:, None, None])
            & ((d1[:, 1, None, None] == 0) | (M.cell_color(grid) == d1[:, 1, None, None])))
