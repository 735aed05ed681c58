"""RoomGrid: the multi-room scaffolding, batch-first.

Counterpart of ``minigrid_tpu/core/roomgrid.py``.  For a fixed (num_rows,
num_cols, room_size) the room lattice is static; what a generator builds lives
in a *builder* dict of ``[B, ...]`` tensors, one row per env, threaded through
the builder methods:

* ``grid`` — int32[B, W, H] packed cells;
* ``door_pos`` — int32[B, n_walls, 2], one sampled cell per internal wall
  (the reference samples a position for every wall up front, used or not);
* ``has_door`` — bool[B, n_walls], connectivity (door placed or wall removed);
* ``locked`` — bool[B, n_rooms], per-room locked flags;
* ``obj_mask`` — bool[B, 30], the (kind, color) combos present, for
  distractor uniqueness;
* ``agent_pos`` int32[B, 2], ``agent_dir`` int32[B].

Where the JAX package runs one env's builder under ``vmap``, every method here
takes one key per env (``[B, 2]``) and works on the whole batch.  A room
coordinate, a door side, a color or a flag is a Python value (the same for
every env) or a tensor of one value per env.  ``connect_all`` is the JAX
package's closed form: the accepted doors of the reference's rejection loop
are the minimal connecting prefix of one random permutation of the eligible
walls, found by Floyd–Warshall minimax passes over the room graph.

Tracing (``utils/trace.py``) sees the generator's stages ``init_rooms``,
``connect_all`` and ``add_distractors`` as the spans ``roomgrid.rooms``,
``roomgrid.connect`` and ``roomgrid.distractors``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS, rand_color
from minigrid_tpu_torch.core.state import EnvParams, empty_grid, fixed_pose
from minigrid_tpu_torch.ops import distractors
from minigrid_tpu_torch.utils import trace

_DOOR = C.OBJECT_TO_IDX["door"]
_CLOSED = C.STATE_TO_IDX["closed"]
_LOCKED = C.STATE_TO_IDX["locked"]
_KIND_IDS = np.asarray(
    [C.OBJECT_TO_IDX["key"], C.OBJECT_TO_IDX["ball"], C.OBJECT_TO_IDX["box"]],
    dtype=np.int32,
)
_KINDS = {"key": 0, "ball": 1, "box": 2}
_NUM_COMBOS = 3 * 10  # (kind, color) pairs


def _is_tensor(*values) -> bool:
    return any(isinstance(v, torch.Tensor) for v in values)


def per_env(v, n: int, device, dtype=torch.int32) -> torch.Tensor:
    """A Python value (the same for every env) or a tensor of one value per
    env -> ``dtype[n]``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).expand(n)
    return torch.full((n,), v, dtype=dtype, device=device)


def _column(table: torch.Tensor, idx) -> torch.Tensor:
    """``table[b, idx[b]]`` of a ``[B, n]`` table, for an int index or one
    per env."""
    if isinstance(idx, torch.Tensor):
        return table.gather(1, idx.to(torch.int64)[:, None])[:, 0]
    return table[:, idx]


def _one_hot(idx, count: int, device) -> torch.Tensor:
    """bool[B, count] (or [1, count] for an int index): True at ``idx``."""
    slots = torch.arange(count, device=device)
    if isinstance(idx, torch.Tensor):
        return slots == idx[:, None]
    return (slots == idx)[None]


def type_triple(kind, color, n: int, device) -> torch.Tensor:
    """uint8[n, 3] cells (kind, color, state 0); each a value or per env."""
    return torch.stack([per_env(kind, n, device), per_env(color, n, device),
                        torch.zeros((n,), dtype=torch.int32, device=device)],
                       dim=1).to(torch.uint8)


def color_rank(color, device):
    """The rank of a color id among the sorted color names (``argmax`` of the
    match: 0 where none matches), as a Python int or per env."""
    if not isinstance(color, torch.Tensor):
        hits = np.flatnonzero(SORTED_COLOR_IDS == int(color))
        return int(hits[0]) if hits.size else 0
    table = G.const(SORTED_COLOR_IDS, device, torch.int32)
    return (table == color[:, None]).to(torch.int32).argmax(dim=1).to(torch.int32)


def stamp_words(grid: torch.Tensor, pos: torch.Tensor, words: torch.Tensor,
                ok: torch.Tensor) -> torch.Tensor:
    """Write ``words`` int32[B, K] at ``pos`` int32[B, K, 2] where ``ok``
    bool[B, K], in one scatter.  The K cells of an env must be distinct where
    ``ok``, so the order of the writes does not matter; writes that are not
    ``ok`` land in a spare column that is dropped."""
    b, w, h = grid.shape
    idx = pos[..., 0].to(torch.int64) * h + pos[..., 1].to(torch.int64)
    idx = torch.where(ok, idx, w * h)
    flat = torch.cat([grid.reshape(b, w * h), grid.new_zeros((b, 1))], dim=1)
    return flat.scatter(1, idx, words)[:, :w * h].reshape(b, w, h)


class RoomGridEnv(Env):
    """Base class for multi-room envs.  Subclasses call the builder API inside
    :meth:`generate`."""

    # connect_all and the room draws dwarf the step; RoomGrid tasks end on
    # success at scattered steps, so the batch engine serves auto-resets from
    # the pooled ring with narrow refill windows (B/64), as the JAX package
    # does.
    expensive_generation = True
    desynchronized_resets = True
    pool_refill_fraction = 1 / 64

    def __init__(self, room_size: int = 7, num_rows: int = 3, num_cols: int = 3,
                 max_steps: int = 100, agent_view_size: int = 7, **kwargs):
        if not (room_size >= 3 and num_rows > 0 and num_cols > 0):
            raise ValueError("RoomGrid needs room_size >= 3 and at least one room")
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        height = (room_size - 1) * num_rows + 1
        width = (room_size - 1) * num_cols + 1
        super().__init__(width=width, height=height, max_steps=max_steps,
                         see_through_walls=False, agent_view_size=agent_view_size,
                         **kwargs)
        self._build_wall_tables()

    # ------------------------------------------------------------------ #
    # static lattice geometry
    # ------------------------------------------------------------------ #

    def _build_wall_tables(self):
        """Static wall enumeration: horizontal-neighbor walls first (right of
        room (i, j), i < cols - 1, j-major), then vertical-neighbor walls
        (below room (i, j), j < rows - 1, j-major)."""
        rows, cols, s = self.num_rows, self.num_cols, self.room_size
        self.num_h_walls = rows * (cols - 1)
        self.num_v_walls = (rows - 1) * cols
        self.num_walls = self.num_h_walls + self.num_v_walls
        r1, r2 = [], []
        for j in range(rows):
            for i in range(cols - 1):
                r1.append(j * cols + i)
                r2.append(j * cols + i + 1)
        for j in range(rows - 1):
            for i in range(cols):
                r1.append(j * cols + i)
                r2.append((j + 1) * cols + i)
        self._wall_r1 = np.asarray(r1, dtype=np.int64)
        self._wall_r2 = np.asarray(r2, dtype=np.int64)
        # the wall -> (room, room) incidence, symmetric: connect_all's edge
        # matrix is a masked min over it
        n_rooms = rows * cols
        m = np.zeros((self.num_walls, n_rooms, n_rooms), bool)
        m[np.arange(self.num_walls), self._wall_r1, self._wall_r2] = True
        self._wall_pair_mask = m | m.transpose(0, 2, 1)
        # the door slot of each wall: a fixed coordinate across the wall and
        # the room's offset along it, to which init_rooms adds a draw
        jj, ii = np.meshgrid(np.arange(rows), np.arange(cols - 1), indexing="ij")
        self._h_x = ((ii + 1) * (s - 1)).ravel()
        self._h_y0 = (jj * (s - 1)).ravel()
        jj, ii = np.meshgrid(np.arange(rows - 1), np.arange(cols), indexing="ij")
        self._v_y = ((jj + 1) * (s - 1)).ravel()
        self._v_x0 = (ii * (s - 1)).ravel()
        # every room's wall outline, the grid each level starts from
        grid = empty_grid(self.width, self.height, "cpu")
        for j in range(rows):
            for i in range(cols):
                grid = G.wall_rect(grid, i * (s - 1), j * (s - 1), s, s)
        self._lattice = grid.numpy()

    def room_top(self, i, j):
        s = self.room_size
        return i * (s - 1), j * (s - 1)

    def h_wall_id(self, i, j):
        """Wall right of room (i, j)."""
        return j * (self.num_cols - 1) + i

    def v_wall_id(self, i, j):
        """Wall below room (i, j)."""
        return self.num_h_walls + j * self.num_cols + i

    def wall_id_for(self, i, j, k):
        """(room i, j, door side k in {0: right, 1: down, 2: left, 3: up}) ->
        (wall id, valid), clipped to the wall range.  Python ints give Python
        values; any tensor argument gives int32/bool tensors of the batch."""
        rows, cols, nw = self.num_rows, self.num_cols, self.num_walls
        if not _is_tensor(i, j, k):
            i, j, k = int(i), int(j), int(k)
            wid = (self.h_wall_id(i, j) if k == 0 else
                   self.h_wall_id(i - 1, j) if k == 2 else
                   self.v_wall_id(i, j) if k == 1 else self.v_wall_id(i, j - 1))
            valid = (i < cols - 1 if k == 0 else i > 0 if k == 2 else
                     j < rows - 1 if k == 1 else j > 0)
            return min(max(wid, 0), nw - 1), valid
        like = next(v for v in (i, j, k) if isinstance(v, torch.Tensor))
        i, j, k = (per_env(v, like.shape[0], like.device) for v in (i, j, k))
        wid = torch.where(
            k == 0, self.h_wall_id(i, j),
            torch.where(k == 2, self.h_wall_id(i - 1, j),
                        torch.where(k == 1, self.v_wall_id(i, j),
                                    self.v_wall_id(i, j - 1))))
        valid = torch.where(
            k == 0, i < cols - 1,
            torch.where(k == 2, i > 0, torch.where(k == 1, j < rows - 1, j > 0)))
        return wid.clamp(0, nw - 1), valid

    # ------------------------------------------------------------------ #
    # builder construction
    # ------------------------------------------------------------------ #

    def init_rooms(self, keys: torch.Tensor, params: EnvParams) -> dict:
        """The builder of a batch of fresh levels: every room's walls, a door
        slot drawn on every internal wall (one ``randint`` per wall class, in
        the wall order), the agent mid-grid facing right."""
        with trace.span("roomgrid.rooms"):
            rows, cols, s = self.num_rows, self.num_cols, self.room_size
            dev = keys.device
            n = keys.shape[0]
            if (params.width, params.height) != (self.width, self.height):
                raise ValueError("RoomGrid params must match the lattice's size")
            _, k_h, k_v = rng.split(keys, 3).unbind(1)
            parts = []
            if self.num_h_walls:
                hy = (G.const(self._h_y0, dev, torch.int32)
                      + rng.randint(k_h, (self.num_h_walls,), 1, s - 1))
                hx = G.const(self._h_x, dev, torch.int32).expand(n, -1)
                parts.append(torch.stack([hx, hy], dim=-1))
            if self.num_v_walls:
                vx = (G.const(self._v_x0, dev, torch.int32)
                      + rng.randint(k_v, (self.num_v_walls,), 1, s - 1))
                vy = G.const(self._v_y, dev, torch.int32).expand(n, -1)
                parts.append(torch.stack([vx, vy], dim=-1))
            door_pos = (torch.cat(parts, dim=1) if parts
                        else torch.zeros((n, 0, 2), dtype=torch.int32, device=dev))
            mid = ((cols // 2) * (s - 1) + s // 2, (rows // 2) * (s - 1) + s // 2)
            agent_pos, agent_dir = fixed_pose(n, mid, 0, dev)
            grid = G.const(self._lattice, dev, torch.int32)
            return {
                "grid": grid.expand(n, -1, -1),
                "door_pos": door_pos,
                "has_door": torch.zeros((n, self.num_walls), dtype=torch.bool, device=dev),
                "locked": torch.zeros((n, rows * cols), dtype=torch.bool, device=dev),
                "obj_mask": torch.zeros((n, _NUM_COMBOS), dtype=torch.bool, device=dev),
                "agent_pos": agent_pos,
                "agent_dir": agent_dir,
            }

    # ------------------------------------------------------------------ #
    # builder ops
    # ------------------------------------------------------------------ #

    def room_rect_mask(self, params: EnvParams, i, j, device) -> torch.Tensor:
        """Room (i, j)'s cells, walls included: (W, H), or [B, W, H] for a
        room per env."""
        return G.rect_mask(params.width, params.height, self.room_top(i, j),
                           (self.room_size, self.room_size), device)

    def add_door(self, b: dict, keys: torch.Tensor, i, j, door_idx=None,
                 color=None, locked=None, enabled=True
                 ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """A door on wall ``door_idx`` of room (i, j).  ``door_idx=None``
        draws a side uniformly among those with a neighbor and no door yet (a
        ``categorical`` over the four sides); ``enabled`` gates every write.
        Returns (builder, door triple uint8[B, 3], door cell int32[B, 2])."""
        dev = keys.device
        n = keys.shape[0]
        k_c, k_l, k_side = rng.split(keys, 3).unbind(1)
        if door_idx is None:
            valids = []
            for side in range(4):
                wid, valid = self.wall_id_for(i, j, side)
                free = ~_column(b["has_door"], wid)
                valids.append(free & valid if isinstance(valid, torch.Tensor)
                              else free & bool(valid))
            logits = torch.where(torch.stack(valids, dim=1), 0.0, -torch.inf)
            door_idx = rng.categorical(k_side, logits)
        if color is None:
            color = rand_color(k_c)
        if locked is None:
            locked = rng.randint(k_l, (), 0, 2) == 0
        locked = per_env(locked, n, dev, torch.bool)

        wid, _ = self.wall_id_for(i, j, door_idx)
        if isinstance(wid, torch.Tensor):
            pos = G.take_row(b["door_pos"], wid)
        else:
            pos = b["door_pos"][:, wid]
        state = torch.where(locked, _LOCKED, _CLOSED).to(torch.int32)
        triple = torch.stack([torch.full_like(state, _DOOR), per_env(color, n, dev),
                              state], dim=1).to(torch.uint8)
        room = j * self.num_cols + i
        b = dict(b)
        b["grid"] = G.put_if(b["grid"], pos[:, 0], pos[:, 1], triple, enabled)
        on = per_env(enabled, n, dev, torch.bool)[:, None]
        b["has_door"] = b["has_door"] | (_one_hot(wid, self.num_walls, dev) & on)
        # room.locked = locked, an unconditional assignment in the reference
        b["locked"] = torch.where(
            _one_hot(room, self.num_rows * self.num_cols, dev) & on,
            locked[:, None], b["locked"])
        return b, triple, pos

    def remove_wall(self, b: dict, i: int, j: int, wall_idx: int) -> dict:
        """Open the whole wall ``wall_idx`` of room (i, j) (static
        arguments)."""
        s = self.room_size
        tx, ty = i * (s - 1), j * (s - 1)
        empty = C.EMPTY_TRIPLE
        g = b["grid"]
        if wall_idx == 0:
            g = G.vert_wall(g, tx + s - 1, ty + 1, s - 2, empty)
        elif wall_idx == 1:
            g = G.horz_wall(g, tx + 1, ty + s - 1, s - 2, empty)
        elif wall_idx == 2:
            g = G.vert_wall(g, tx, ty + 1, s - 2, empty)
        elif wall_idx == 3:
            g = G.horz_wall(g, tx + 1, ty, s - 2, empty)
        else:
            raise ValueError("invalid wall index")
        wid, _ = self.wall_id_for(i, j, wall_idx)
        b = dict(b)
        b["grid"] = g
        b["has_door"] = b["has_door"].clone()
        b["has_door"][:, wid] = True
        return b

    def _room_free_cells(self, b: dict, params: EnvParams, i, j) -> torch.Tensor:
        """Empty cells of room (i, j) at manhattan distance >= 2 from the
        agent: bool[B, W, H]."""
        dev = b["grid"].device
        xs, ys = G.coords(params.width, params.height, dev)
        pos = b["agent_pos"]
        near_agent = ((xs - pos[:, 0, None, None]).abs()
                      + (ys - pos[:, 1, None, None]).abs()) < 2
        return (G.is_empty(b["grid"]) & self.room_rect_mask(params, i, j, dev)
                & ~near_agent)

    def place_in_room(self, b: dict, keys: torch.Tensor, params: EnvParams,
                      i, j, triple, enabled=True
                      ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """Uniform over the room's empty cells at manhattan distance >= 2
        from the agent; ``enabled`` gates the write.  Returns (builder,
        pos int32[B, 2], ok bool[B])."""
        mask = self._room_free_cells(b, params, i, j)
        pos, ok = G.sample_cell(keys, mask)
        if isinstance(enabled, torch.Tensor):
            ok = ok & enabled
        elif not enabled:
            ok = torch.zeros_like(ok)
        b = dict(b)
        b["grid"] = G.put_if(b["grid"], pos[:, 0], pos[:, 1], triple, ok)
        return b, pos, ok

    def add_object(self, b: dict, keys: torch.Tensor, params: EnvParams, i, j,
                   kind=None, color=None, enabled=True
                   ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """A key, ball or box in room (i, j).  ``kind``: None (drawn),
        ``'key'``/``'ball'``/``'box'``, or a local kind index 0/1/2 per env.
        Records the (kind, color) combo in ``obj_mask``.  Returns (builder,
        triple uint8[B, 3], pos int32[B, 2])."""
        dev = keys.device
        n = keys.shape[0]
        k_kind, k_color, k_pos = rng.split(keys, 3).unbind(1)
        if kind is None:
            kind_local = rng.randint(k_kind, (), 0, 3)
        elif isinstance(kind, str):
            kind_local = _KINDS[kind]
        else:
            kind_local = kind
        if color is None:
            color = rand_color(k_color)
        if isinstance(kind_local, torch.Tensor):
            t = G.take_vec(G.const(_KIND_IDS, dev, torch.int32), kind_local)
        else:
            t = int(_KIND_IDS[kind_local])
        triple = type_triple(t, color, n, dev)
        b, pos, ok = self.place_in_room(b, k_pos, params, i, j, triple,
                                        enabled=enabled)
        slot = per_env(kind_local * 10 + color_rank(color, dev), n, dev, torch.int64)
        combos = torch.arange(_NUM_COMBOS, device=dev)
        b["obj_mask"] = b["obj_mask"] | ((combos == slot[:, None]) & ok[:, None])
        return b, triple, pos

    def place_agent_in_room(self, b: dict, keys: torch.Tensor, params: EnvParams,
                            i, j) -> dict:
        """Uniform over the (cell, direction) pairs of room (i, j) whose cell
        is empty and whose front cell is empty or a wall: one ``categorical``
        over W·H·4 pairs (all of them when none qualifies)."""
        h = params.height
        dev = keys.device
        empty = G.is_empty(b["grid"]) & self.room_rect_mask(params, i, j, dev)
        types = G.types(b["grid"])
        ok_dirs = []
        for d in range(4):
            dx, dy = int(C.DIR_TO_VEC[d][0]), int(C.DIR_TO_VEC[d][1])
            # grid borders are walls, so a wrapped front cell is never picked
            front = torch.roll(types, (-dx, -dy), dims=(1, 2))
            ok_dirs.append((front == C.OBJECT_TO_IDX["empty"])
                           | (front == C.OBJECT_TO_IDX["wall"]))
        flat = (torch.stack(ok_dirs, dim=-1) & empty[..., None]).flatten(1)
        logits = torch.where(flat | ~flat.any(dim=1, keepdim=True), 0.0, -torch.inf)
        idx = rng.categorical(keys, logits)
        cell = idx // 4
        b = dict(b)
        b["agent_pos"] = torch.stack([cell // h, cell % h], dim=1).to(torch.int32)
        b["agent_dir"] = (idx % 4).to(torch.int32)
        return b

    def connect_all(self, b: dict, keys: torch.Tensor, exclude_color=None) -> dict:
        """Doors until every room is reachable from the agent's room.

        The reference draws random walls and accepts each at most once,
        stopping once the rooms connect: the accepted walls are a uniform
        permutation's minimal connecting prefix of the eligible walls, each
        door an independent uniform color.  So: one permutation, the
        minimax rank to reach each room (Floyd–Warshall over the room graph),
        the longest such rank as the prefix, and one write of every new door.
        Walls touching locked rooms are ineligible, and rooms behind them are
        left out of the target.  ``exclude_color`` (an id, or a negative
        sentinel for none; per env or not) keeps that color off the doors.
        The JAX version's unused ``max_itrs`` argument is not carried."""
        with trace.span("roomgrid.connect"):
            rows, cols, s = self.num_rows, self.num_cols, self.room_size
            n_rooms, n_walls = rows * cols, self.num_walls
            if n_walls == 0:  # a single room: nothing to connect
                return b
            dev = keys.device
            n = keys.shape[0]
            big = n_walls + 1
            pos = b["agent_pos"]
            start_room = pos[:, 1] // (s - 1) * cols + pos[:, 0] // (s - 1)

            k_perm, k_col = rng.split(keys).unbind(1)
            rank = rng.permutation(k_perm, n_walls)
            r1 = G.const(self._wall_r1, dev)
            r2 = G.const(self._wall_r2, dev)
            locked = b["locked"]
            eligible = ~b["has_door"] & ~locked[:, r1] & ~locked[:, r2]
            # existing doors connect for free, eligible walls open at their rank,
            # the rest never
            edge = torch.where(b["has_door"], -1, torch.where(eligible, rank, big))
            pair = G.const(self._wall_pair_mask, dev, torch.bool)
            dist = torch.where(pair, edge[:, :, None, None], big).amin(dim=1)
            eye = G.const(np.eye(n_rooms, dtype=bool), dev, torch.bool)
            dist = torch.where(eye, -1, dist).to(torch.int32)
            for k in range(n_rooms):
                via = torch.maximum(dist[:, :, k:k + 1], dist[:, k:k + 1, :])
                dist = torch.minimum(dist, via)
            bottleneck = G.take_row(dist, start_room)  # [B, n_rooms]
            prefix = torch.where(bottleneck < big, bottleneck, -1).amax(dim=1)
            new_door = eligible & (rank <= prefix[:, None])

            sorted_ids = G.const(SORTED_COLOR_IDS, dev, torch.int32)
            if exclude_color is None:
                colors = rand_color(rng.split(k_col, n_walls))
            else:
                # uniform over the colors but exclude_color while it is a real
                # color id; a negative sentinel keeps the whole palette
                active = per_env(exclude_color, n, dev) > 0
                ex_rank = per_env(color_rank(per_env(exclude_color, n, dev), dev), n, dev)
                r = rng.randint(k_col, (n_walls,), 0,
                                torch.where(active, 9, 10)[:, None])
                skip = active[:, None] & (r >= ex_rank[:, None])
                colors = G.take_vec(sorted_ids, r + skip.to(torch.int32))
            doors = (_DOOR | (colors.to(torch.int32) << 8) | (_CLOSED << 16))
            b = dict(b)
            b["grid"] = stamp_words(b["grid"], b["door_pos"], doors, new_door)
            b["has_door"] = b["has_door"] | new_door
            return b

    def add_distractors(self, b: dict, keys: torch.Tensor, params: EnvParams,
                        i=None, j=None, num_distractors: int = 10,
                        all_unique: bool = True, enabled=True,
                        color_override=None
                        ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """Random key/ball/box distractors.  Uniqueness is a draw over the 30
        (kind, color) combos not yet present.  ``color_override`` forces the
        written color while the draws stay as they are.  Returns (builder,
        int32[B, num, 2] (type id, color id), int32[B, num, 2] positions).
        With a room drawn per object on a CUDA tensor, the whole loop is one
        launch of ``ops/distractors.py``'s kernel."""
        with trace.span("roomgrid.distractors"):
            dev = keys.device
            n = keys.shape[0]
            single_room = self.num_rows == 1 and self.num_cols == 1
            if (single_room or (i is not None and j is not None)) and num_distractors:
                return self._add_distractors_oneshot(
                    b, keys, params, 0 if i is None else i, 0 if j is None else j,
                    num_distractors, all_unique, enabled, color_override)
            if not num_distractors:
                none = torch.zeros((n, 0, 2), dtype=torch.int32, device=dev)
                return b, none, none.clone()

            if dev.type != "cpu":
                return distractors.place(
                    b, keys, (self.num_rows, self.num_cols, self.room_size), i, j,
                    num_distractors, all_unique, enabled, color_override)
            return self._add_distractors_plain(b, keys, params, i, j, num_distractors,
                                               all_unique, enabled, color_override)

    def _add_distractors_plain(self, b: dict, keys: torch.Tensor, params: EnvParams,
                               i, j, num: int, all_unique: bool, enabled, color_override
                               ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """The sequential path as eager ops, the plain version of
        ``ops/distractors.py``'s kernel: the JAX package's lax.scan, each draw
        consuming the builder the last one produced, the key chain
        ``split(key, 5)[0]`` per draw."""
        dev = keys.device
        sorted_ids = G.const(SORTED_COLOR_IDS, dev, torch.int32)
        kind_ids = G.const(_KIND_IDS, dev, torch.int32)
        added, positions = [], []
        for _ in range(num):
            keys, k_tc, k_i, k_j, k_pos = rng.split(keys, 5).unbind(1)
            if all_unique:
                logits = torch.where(b["obj_mask"], -torch.inf, 0.0)
                combo = rng.categorical(k_tc, logits)
            else:
                combo = rng.randint(k_tc, (), 0, _NUM_COMBOS)
            kind_local = combo // 10
            color = G.take1(sorted_ids, combo % 10)
            write_color = color if color_override is None else color_override
            ri = rng.randint(k_i, (), 0, self.num_cols) if i is None else i
            rj = rng.randint(k_j, (), 0, self.num_rows) if j is None else j
            b, _, pos = self.add_object(b, k_pos, params, ri, rj, kind=kind_local,
                                        color=write_color, enabled=enabled)
            added.append(torch.stack([G.take1(kind_ids, kind_local), color], dim=1))
            positions.append(pos)
        return b, torch.stack(added, dim=1), torch.stack(positions, dim=1)

    def _add_distractors_oneshot(self, b: dict, keys: torch.Tensor,
                                 params: EnvParams, i, j, num: int,
                                 all_unique: bool, enabled, color_override
                                 ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """``num`` distractors in one room at once: the top ``num`` of iid
        uniform priorities over the combos (without replacement) and over the
        room's free cells.  A priority of exactly 0.0 counts as not drawn."""
        dev = keys.device
        n = keys.shape[0]
        w, h = params.width, params.height
        k_combo, k_pri = rng.split(keys).unbind(1)

        if all_unique:
            cp = torch.where(b["obj_mask"], -1.0, rng.uniform(k_combo, (_NUM_COMBOS,)))
            cvals, combos = rng.top_k(cp, num)
            combo_ok = cvals > 0
        else:
            combos = rng.randint(k_combo, (num,), 0, _NUM_COMBOS)
            combo_ok = torch.ones((n, num), dtype=torch.bool, device=dev)
        kind_local = combos // 10
        color = G.take_vec(G.const(SORTED_COLOR_IDS, dev, torch.int32), combos % 10)
        write_color = (color if color_override is None
                       else per_env(color_override, n, dev)[:, None].expand(n, num))

        mask = self._room_free_cells(b, params, i, j).reshape(n, w * h)
        pri = torch.where(mask, rng.uniform(k_pri, (w * h,)), -1.0)
        pvals, idx = rng.top_k(pri, num)
        ok = (pvals > 0) & combo_ok & per_env(enabled, n, dev, torch.bool)[:, None]
        pos = torch.stack([idx // h, idx % h], dim=-1)

        kinds_t = G.take_vec(G.const(_KIND_IDS, dev, torch.int32), kind_local)
        b = dict(b)
        b["grid"] = stamp_words(b["grid"], pos, kinds_t | (write_color << 8), ok)
        slots = torch.arange(_NUM_COMBOS, device=dev)
        hit = ((slots[None, None, :] == combos[..., None]) & ok[..., None]).any(dim=1)
        b["obj_mask"] = b["obj_mask"] | hit
        return b, torch.stack([kinds_t, color], dim=-1), pos
