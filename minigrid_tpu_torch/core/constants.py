"""Integer encodings and behavior tables of the MiniGrid object model.

The port's own copy of ``minigrid_tpu/core/constants.py``: the object-type /
color / door-state codings, the direction vectors, the per-type behavior
predicates (``can_overlap`` / ``can_pickup`` / ``see_behind``) as constant
bool vectors indexed by type id, and the canonical cell triples.  Plain numpy,
so both the host and every device path read the same tables.
"""

from __future__ import annotations

import numpy as np

# Color name -> RGB, the reference palette.
COLORS = {
    "red": np.array([255, 0, 0], dtype=np.uint8),
    "green": np.array([0, 255, 0], dtype=np.uint8),
    "blue": np.array([0, 0, 255], dtype=np.uint8),
    "purple": np.array([112, 39, 195], dtype=np.uint8),
    "yellow": np.array([255, 255, 0], dtype=np.uint8),
    "grey": np.array([100, 100, 100], dtype=np.uint8),
    "white": np.array([255, 255, 255], dtype=np.uint8),
    "cyan": np.array([0, 255, 255], dtype=np.uint8),
    "brown": np.array([139, 69, 19], dtype=np.uint8),
    "orange": np.array([255, 99, 71], dtype=np.uint8),
}

COLOR_NAMES = sorted(COLORS.keys())

# Color ids start at 1; 0 is "no color".
COLOR_TO_IDX = {
    "red": 1,
    "green": 2,
    "blue": 3,
    "purple": 4,
    "yellow": 5,
    "grey": 6,
    "white": 7,
    "cyan": 8,
    "brown": 9,
    "orange": 10,
}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}
NUM_COLORS = 11

# Object type ids — the full 34-entry table.
OBJECT_TO_IDX = {
    "unseen": 0,
    "empty": 1,
    "wall": 2,
    "floor": 3,
    "door": 4,
    "block": 5,
    "north": 6,
    "east": 7,
    "south": 8,
    "west": 9,
    "agent": 10,
    "square": 11,
    "circle": 12,
    "oval": 13,
    "line": 14,
    "rectangle": 15,
    "diamond": 16,
    "ring": 17,
    "cross": 18,
    "star": 19,
    "arrow": 20,
    "key": 21,
    "ball": 22,
    "box": 23,
    "tree": 24,
    "cup": 25,
    "tool": 26,
    "building": 27,
    "crate": 28,
    "chair": 29,
    "flower": 30,
    "goal": 31,
    "lava": 32,
    "gripped_block": 33,
}
IDX_TO_OBJECT = {v: k for k, v in OBJECT_TO_IDX.items()}
NUM_OBJECT_TYPES = 34

OBJECT_NAMES = sorted(OBJECT_TO_IDX.keys())
NON_BASE_OBJ_NAMES = [
    o
    for o in OBJECT_NAMES
    if o not in ["unseen", "empty", "wall", "floor", "door", "goal", "lava", "agent"]
]

STATE_TO_IDX = {"open": 0, "closed": 1, "locked": 2}
IDX_TO_STATE = {v: k for k, v in STATE_TO_IDX.items()}

# Direction id -> unit vector, (x, y): 0 east, 1 south, 2 west, 3 north.
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)

_T = OBJECT_TO_IDX


def _table(true_names: list[str]) -> np.ndarray:
    t = np.zeros(NUM_OBJECT_TYPES, dtype=bool)
    for n in true_names:
        t[_T[n]] = True
    return t


# "empty" is walkable; goal/floor/lava can be overlapped; doors only when
# open (applied by the step on top of this table).
CAN_OVERLAP = _table(["empty", "floor", "goal", "lava"])

# Every shape/thing + block/gripped_block; not the compass glyphs.
CAN_PICKUP = _table(
    [
        "block",
        "gripped_block",
        "square",
        "circle",
        "oval",
        "line",
        "rectangle",
        "diamond",
        "ring",
        "cross",
        "star",
        "arrow",
        "key",
        "ball",
        "box",
        "tree",
        "cup",
        "tool",
        "building",
        "crate",
        "chair",
        "flower",
    ]
)

# Everything is transparent except walls; doors only when open (applied by
# the occlusion pass on top of this table).
SEE_BEHIND = np.ones(NUM_OBJECT_TYPES, dtype=bool)
SEE_BEHIND[_T["wall"]] = False

# Canonical cell triples (type, color, state).
EMPTY_TRIPLE = np.array([_T["empty"], 0, 0], dtype=np.uint8)
UNSEEN_TRIPLE = np.array([0, 0, 0], dtype=np.uint8)
WALL_TRIPLE = np.array([_T["wall"], COLOR_TO_IDX["grey"], 0], dtype=np.uint8)
GOAL_TRIPLE = np.array([_T["goal"], COLOR_TO_IDX["green"], 0], dtype=np.uint8)
LAVA_TRIPLE = np.array([_T["lava"], COLOR_TO_IDX["red"], 0], dtype=np.uint8)
FLOOR_TRIPLE = np.array([_T["floor"], COLOR_TO_IDX["blue"], 0], dtype=np.uint8)
