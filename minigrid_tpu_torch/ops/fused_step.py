"""The fused env step: CUDA kernel, plain version, wrapper and FusedVectorEnv.

Replaces the JAX package's Pallas kernel ``ops/fused_step.py::_kernel``
(driven by its ``FusedVectorEnv``): the whole transition of a box-free env
whose dynamics are exactly ``base_step`` in one launch — front cell, action
tree, door FSM, pickup/drop/toggle, reward and truncation, closed-form
regeneration of finished envs (DoorKey, Empty), the rotated view gather,
occlusion, the carried-object overlay and unseen = 0.  The kernel is
``csrc/fused_step.cu``: a block per tile of 16 envs, staged in shared memory,
in phases (step, regeneration, view, occlusion, image) between barriers.
See the source for its bound.

The state is a dict of planes, as in the JAX package:

* ``grid`` int32[N, W, H], packed cells (the JAX package's ``[N, LANES]``
  rows without the pad lanes; its lane ``x*H + y`` is the flat index here);
* ``agent`` int32[N, 8]: columns ``A_X, A_Y, A_DIR, A_CNT, A_CTYP, A_CCOL``,
  then two zero columns;
* ``rng`` int64[2], the step key; ``t`` int32[], the step index;
  ``mission`` int32[N, 4].

Random numbers are the JAX interpreter-mode stream, bit for bit: each step
splits its key into (next key, sub) and draws ``randint(sub, (N, 8), 0,
2^24)``.  With that span the draw's multiplier is 0, so value (n, j) is
``bits(split(sub)[1])[n, j] & 0xFFFFFF``, one threefry hash, which the kernel
computes itself; only columns 0-4 are read.

The reward is NOT ``core/step.py::goal_reward``: XLA compiles the JAX
kernel's ``1 - 0.9 * c / max_steps`` into ``fma(c, -K, 1)`` with
``K = f32(f32(0.9) * f32(1 / max_steps))``, rounded once, and both versions
here compute exactly that.  The step count and truncation read the static
``max_steps``, never a per-env limit.

:func:`fused_step` takes the plain version for tensors on the CPU and the
kernel for CUDA tensors; on a CUDA tensor it launches the kernel or raises.
``trace.launches("fused_step")`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.obs import process_vis
from minigrid_tpu_torch.core.state import EnvParams, base_state, resolve_device
from minigrid_tpu_torch.core.step import _fma_f32, dir_to_vec
from minigrid_tpu_torch.ops._build import Kernel, check_launch, check_tensor
from minigrid_tpu_torch.ops.obs_gather import gather_view_plain
from minigrid_tpu_torch.utils import trace

A_X, A_Y, A_DIR, A_CNT, A_CTYP, A_CCOL = range(6)
A_WIDTH = 8

GEN_DOORKEY, GEN_EMPTY, GEN_EMPTY_RANDOM = range(3)
DRAW_COLUMNS = 8
DRAW_SPAN = 1 << 24
MAX_VIEW = 31  # occlusion keeps one view column per 32-bit word
TILE = 16  # envs per block (csrc/fused_step.cu kTile)

_EMPTY = C.OBJECT_TO_IDX["empty"]
_WALL = C.OBJECT_TO_IDX["wall"]
_DOOR = C.OBJECT_TO_IDX["door"]
_KEY = C.OBJECT_TO_IDX["key"]
_BALL = C.OBJECT_TO_IDX["ball"]
_GOAL = C.OBJECT_TO_IDX["goal"]
_LAVA = C.OBJECT_TO_IDX["lava"]
_OPEN = C.STATE_TO_IDX["open"]
_LOCKED = C.STATE_TO_IDX["locked"]
_GREY = C.COLOR_TO_IDX["grey"]
_GREEN = C.COLOR_TO_IDX["green"]
_YELLOW = C.COLOR_TO_IDX["yellow"]

KERNEL = Kernel("fused_step", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float]
                + [ctypes.c_int] * 5)


@dataclass(frozen=True)
class FusedSpec:
    """What the fused step is compiled for: grid, view, episode limit,
    occlusion, and the generator of finished envs (with the fixed start of
    ``GEN_EMPTY``)."""

    width: int
    height: int
    view: int
    max_steps: int
    see_through_walls: bool
    generator: int
    start_x: int = 1
    start_y: int = 1
    start_dir: int = 0



def fused_tile_bytes(width: int, height: int, view: int) -> int:
    """Shared memory of one block of the fused kernel: per env its grid row,
    agent row (8), action, level (4), done, view frame (4), carried and
    column words, and its image bytes (``csrc/fused_step.cu::tile_bytes``)."""
    return 4 * TILE * (width * height + 19 + view) + 3 * TILE * view * view


def reward_factor(max_steps: int) -> float:
    """K = f32(f32(0.9) * f32(1 / max_steps)), as XLA folds the JAX kernel's
    ``0.9 * c / max_steps``."""
    return float(np.float32(np.float32(0.9) * np.float32(1 / max_steps)))


def fused_goal_reward(count: torch.Tensor, max_steps: int) -> torch.Tensor:
    """The fused step's goal reward for int32 step counts (already
    incremented): ``fma(count, -K, 1)`` rounded once to float32."""
    neg_k = torch.full(count.shape, -reward_factor(max_steps), dtype=torch.float32,
                       device=count.device)
    return _fma_f32(count.to(torch.float32), neg_k, 1.0)


def fused_spec(env, params: EnvParams) -> FusedSpec:
    """The spec of a supported env: DoorKey, or Empty with a fixed or a
    random start.  Anything else raises ``NotImplementedError``."""
    name = type(env).__name__
    common = dict(width=params.width, height=params.height,
                  view=params.agent_view_size, max_steps=params.max_steps,
                  see_through_walls=params.see_through_walls)
    if name == "DoorKeyEnv":
        return FusedSpec(generator=GEN_DOORKEY, **common)
    if name == "EmptyEnv":
        start = getattr(env, "agent_start_pos", (1, 1))
        if start is None:
            return FusedSpec(generator=GEN_EMPTY_RANDOM, **common)
        return FusedSpec(generator=GEN_EMPTY, start_x=int(start[0]),
                         start_y=int(start[1]),
                         start_dir=int(getattr(env, "agent_start_dir", 0)), **common)
    raise NotImplementedError(
        f"{name} has no fused generator; use parallel.vector.VectorEnv")


# -- plain version --------------------------------------------------------------

def _pack(t, c, s):
    return t | (c << 8) | (s << 16)


def generate_plain(r: torch.Tensor, spec: FusedSpec):
    """The closed-form level of each row of draws ``r`` (int32[N, 8], values
    in [0, 2^24)): (grid int32[N, W, H], x, y, dir int32[N])."""
    w, h = spec.width, spec.height
    n = r.shape[0]
    lx, ly = G.coords(w, h, r.device)
    border = (lx == 0) | (lx == w - 1) | (ly == 0) | (ly == h - 1)
    goal = (lx == w - 2) & (ly == h - 2)
    full = lambda v: torch.full((n,), v, dtype=torch.int32, device=r.device)  # noqa: E731
    if spec.generator == GEN_DOORKEY:
        split = 2 + r[:, 0] % (w - 4)
        door_y = 1 + r[:, 1] % (w - 3)  # W, as the JAX kernel has it
        rows = h - 2
        nfree = (split - 1) * rows
        r1 = r[:, 2] % nfree
        r2 = r[:, 3] % torch.clamp(nfree - 1, min=1)
        r2 = r2 + (r2 >= r1).to(torch.int32)
        ax, ay = 1 + r1 // rows, 1 + r1 % rows
        kx, ky = 1 + r2 // rows, 1 + r2 % rows
        gdir = r[:, 4] % 4
        wall_col = lx == split[:, None, None]
        door = wall_col & (ly == door_y[:, None, None])
        key = (lx == kx[:, None, None]) & (ly == ky[:, None, None])
        walls = border | wall_col
        typ = torch.where(walls, _WALL, _EMPTY)
        typ = torch.where(goal, _GOAL, typ)
        typ = torch.where(door, _DOOR, typ)
        typ = torch.where(key, _KEY, typ)
        col = torch.where(walls, _GREY, 0)
        col = torch.where(goal, _GREEN, col)
        col = torch.where(door | key, _YELLOW, col)
        sta = torch.where(door, _LOCKED, 0)
    else:
        typ = torch.where(goal, _GOAL, torch.where(border, _WALL, _EMPTY))
        col = torch.where(border, _GREY, torch.where(goal, _GREEN, 0))
        sta = torch.zeros_like(typ)
        if spec.generator == GEN_EMPTY_RANDOM:
            # uniform over the interior minus the goal: draw from nfree - 1
            # slots and shift past the goal's index
            nfree = (w - 2) * (h - 2)
            goal_idx = (w - 3) * (h - 2) + (h - 3)
            r1 = r[:, 2] % (nfree - 1)
            r1 = r1 + (r1 >= goal_idx).to(torch.int32)
            ax, ay = 1 + r1 // (h - 2), 1 + r1 % (h - 2)
            gdir = r[:, 4] % 4
        else:
            ax, ay, gdir = full(spec.start_x), full(spec.start_y), full(spec.start_dir)
        typ, col, sta = (v.expand(n, w, h) for v in (typ, col, sta))
    grid = _pack(typ, col, sta).to(torch.int32)
    return grid, ax.to(torch.int32), ay.to(torch.int32), gdir.to(torch.int32)


def fused_step_plain(grid: torch.Tensor, agent: torch.Tensor, action: torch.Tensor,
                     key: torch.Tensor, t: torch.Tensor, spec: FusedSpec):
    """Plain torch version of the fused step; the arguments and results of
    :func:`fused_step`."""
    w, h, v = spec.width, spec.height, spec.view
    n = grid.shape[0]
    x, y, d, cnt, ctyp, ccol = agent[:, :6].unbind(1)
    a = action

    # front cell, from the pre-action direction
    fdx, fdy = dir_to_vec(d)
    fx, fy = x + fdx, y + fdy
    in_bounds = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    cx, cy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    fcell = G.read_word(grid, cx, cy)
    ftyp = torch.where(in_bounds, fcell & 0xFF, _WALL)
    fcol = torch.where(in_bounds, (fcell >> 8) & 0xFF, 0)
    fsta = torch.where(in_bounds, (fcell >> 16) & 0xFF, 0)

    # action tree
    is_left, is_right, is_fwd = a == 0, a == 1, a == 2
    is_pick, is_drop, is_tog = a == 3, a == 4, a == 5
    nd = torch.where(is_left, (d + 3) % 4, torch.where(is_right, (d + 1) % 4, d))
    can_overlap = ((ftyp == _EMPTY) | (ftyp == _GOAL) | (ftyp == _LAVA)
                   | ((ftyp == _DOOR) & (fsta == _OPEN)))
    moved = is_fwd & can_overlap & in_bounds
    nx = torch.where(moved, fx, x)
    ny = torch.where(moved, fy, y)
    cnt2 = cnt + 1
    hit_goal = is_fwd & (ftyp == _GOAL)
    terminated = hit_goal | (is_fwd & (ftyp == _LAVA))
    reward = fused_goal_reward(cnt2, spec.max_steps)
    reward = torch.where(hit_goal, reward, torch.zeros_like(reward))
    truncated = cnt2 >= spec.max_steps

    hands_free = ctyp == _EMPTY
    can_pickup = (ftyp == _KEY) | (ftyp == _BALL)
    picked = is_pick & can_pickup & hands_free & in_bounds
    dropped = is_drop & (ftyp == _EMPTY) & ~hands_free & in_bounds
    has_key = (ctyp == _KEY) & (ccol == fcol)
    new_door_sta = torch.where(
        fsta == _LOCKED, torch.where(has_key, _OPEN, _LOCKED).to(torch.int32),
        1 - fsta)
    toggling = is_tog & (ftyp == _DOOR) & in_bounds
    new_ftyp = torch.where(picked, _EMPTY, torch.where(dropped, ctyp, ftyp))
    new_fcol = torch.where(picked, 0, torch.where(dropped, ccol, fcol))
    new_fsta = torch.where(picked | dropped, 0,
                           torch.where(toggling, new_door_sta, fsta))
    grid2 = G.write_word(grid, cx, cy, torch.where(
        in_bounds, _pack(new_ftyp, new_fcol, new_fsta), fcell))
    nct = torch.where(picked, ftyp, torch.where(dropped, _EMPTY, ctyp))
    ncc = torch.where(picked, fcol, torch.where(dropped, 0, ccol))

    # regeneration of finished envs
    done = terminated | truncated
    key_next, sub = rng.split(key).unbind(0)
    r = rng.randint(sub, (n, DRAW_COLUMNS), 0, DRAW_SPAN)
    gen_grid, gx, gy, gdir = generate_plain(r, spec)
    grid3 = torch.where(done[:, None, None], gen_grid, grid2)
    nx = torch.where(done, gx, nx)
    ny = torch.where(done, gy, ny)
    nd = torch.where(done, gdir, nd)
    ncnt = torch.where(done, 0, cnt2)
    nct = torch.where(done, _EMPTY, nct)
    ncc = torch.where(done, 0, ncc)
    zero = torch.zeros_like(nx)
    new_agent = torch.stack([nx, ny, nd, ncnt, nct, ncc, zero, zero], dim=1)

    # the view: rotated gather, overlay (before occlusion, as the JAX kernel
    # has it), occlusion, unseen = 0
    cells = gather_view_plain(grid3, new_agent[:, :2].contiguous(), nd, v)
    cells[:, v // 2, v - 1] = _pack(nct, ncc, 0)
    if spec.see_through_walls:
        image = G.unpack_cells(cells)
    else:
        vis = process_vis(cells, v)
        image = G.unpack_cells(torch.where(vis, cells, torch.zeros_like(cells)))
    return (grid3.to(torch.int32), new_agent.to(torch.int32), image, reward,
            terminated, truncated, key_next, t + 1)


# -- kernel -----------------------------------------------------------------------

def fused_step(grid: torch.Tensor, agent: torch.Tensor, action: torch.Tensor,
               key: torch.Tensor, t: torch.Tensor, spec: FusedSpec):
    """One step of every env: grid int32[N, W, H], agent int32[N, 8], action
    int32[N], key int64[2], t int32[] -> (grid, agent, image uint8[N, V, V, 3],
    reward float32[N], terminated bool[N], truncated bool[N], next key
    int64[2], t + 1).  New tensors; the inputs are left as they are."""
    n = grid.shape[0]
    w, h, v = spec.width, spec.height, spec.view
    if not (3 <= v <= MAX_VIEW and v % 2 == 1):
        raise ValueError(f"view must be odd and in [3, {MAX_VIEW}], got {v}")
    if n < 1:
        raise ValueError("fused_step needs at least one env")
    check_launch(fused_tile_bytes(w, h, v), TILE, n, max(w * h, v * v * 3),
                 f"a {w}x{h} grid with view {v}")
    dev = grid.device
    for arg, name, dtype, shape in (
            (grid, "grid", torch.int32, (n, w, h)),
            (agent, "agent", torch.int32, (n, A_WIDTH)),
            (action, "action", torch.int32, (n,)),
            (key, "key", torch.int64, (2,)),
            (t, "t", torch.int32, ())):
        check_tensor(arg, name, dtype, shape, dev)
    if dev.type == "cpu":
        return fused_step_plain(grid, agent, action, key, t, spec)
    KERNEL.check_device(dev)
    out = (torch.empty((n, w, h), dtype=torch.int32, device=dev),
           torch.empty((n, A_WIDTH), dtype=torch.int32, device=dev),
           torch.empty((n, v, v, 3), dtype=torch.uint8, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.bool, device=dev),
           torch.empty((n,), dtype=torch.bool, device=dev),
           torch.empty((2,), dtype=torch.int64, device=dev),
           torch.empty((), dtype=torch.int32, device=dev))
    KERNEL.launch(dev, grid.data_ptr(), agent.data_ptr(), action.data_ptr(), key.data_ptr(),
                  t.data_ptr(), *(o.data_ptr() for o in out), n, w, h, v, spec.max_steps,
                  -reward_factor(spec.max_steps), int(spec.see_through_walls), spec.generator,
                  spec.start_x, spec.start_y, spec.start_dir)
    return out


# -- the batch engine ---------------------------------------------------------------

def planes_from_states(states) -> dict:
    """An ``EnvState`` batch -> the fused planes (``rng`` and ``t`` left to
    the caller)."""
    zero = torch.zeros_like(states.step_count)
    agent = torch.stack([
        states.agent_pos[:, 0], states.agent_pos[:, 1], states.agent_dir,
        states.step_count, states.carrying[:, 0].to(torch.int32),
        states.carrying[:, 1].to(torch.int32), zero, zero], dim=1)
    return {"grid": states.grid.contiguous(), "agent": agent.to(torch.int32),
            "mission": states.mission}


class FusedVectorEnv:
    """Single-kernel vectorized env batch, auto-reset fused in.

        venv = FusedVectorEnv(minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0"), 4096)
        obs, fs = venv.reset(rng.PRNGKey(0))
        obs, fs, reward, terminated, truncated, info = venv.step(fs, actions)

    The API of the JAX package's ``FusedVectorEnv``; ``fs`` is the dict of
    planes above.  ``reset`` generates with ``env.reset`` (the observation
    through the ``obs_gather`` kernel on a card); each ``step`` is one
    ``fused_step`` launch and leaves the given ``fs`` valid.  Runs on CUDA
    unless ``device`` names another.  Tracing sees ``reset`` and ``step`` as
    the spans ``fused.reset`` and ``fused.step``."""

    def __init__(self, env, num_envs: int, params: EnvParams | None = None,
                 device=None):
        self.env = env
        self.num_envs = num_envs
        self.params = params if params is not None else env.default_params
        self.spec = fused_spec(env, self.params)
        self.device = resolve_device(device)

    def reset(self, key: torch.Tensor):
        with trace.span("fused.reset"):
            key = key.to(self.device)
            obs, states = self.env.reset(rng.split(key, self.num_envs), self.params,
                                         self.device)
            fs = planes_from_states(states)
            fs["rng"] = rng.fold_in(key, 1)
            fs["t"] = torch.zeros((), dtype=torch.int32, device=self.device)
            return self._obs_from(obs["image"], fs), fs

    def _obs_from(self, image: torch.Tensor, fs: dict) -> dict:
        return {"image": image, "direction": fs["agent"][:, A_DIR],
                "mission": fs["mission"]}

    def step(self, fs: dict, action: torch.Tensor):
        with trace.span("fused.step"):
            action = action.to(device=self.device, dtype=torch.int32)
            grid, agent, image, reward, term, trunc, key, t = fused_step(
                fs["grid"], fs["agent"], action, fs["rng"], fs["t"], self.spec)
            nfs = {**fs, "grid": grid, "agent": agent, "rng": key, "t": t}
            return self._obs_from(image, nfs), nfs, reward, term, trunc, {}

    def to_env_states(self, fs: dict):
        """The planes -> an ``EnvState`` batch (for rendering or
        checkpointing), with key (0, 0) per env as in the JAX package."""
        ag = fs["agent"]
        n = ag.shape[0]
        states = base_state(fs["grid"], ag[:, A_X:A_Y + 1].contiguous(),
                            ag[:, A_DIR].contiguous(),
                            rng=torch.zeros((n, 2), dtype=torch.int64,
                                            device=ag.device),
                            mission=fs["mission"])
        carrying = torch.stack([ag[:, A_CTYP], ag[:, A_CCOL],
                                torch.zeros_like(ag[:, A_CTYP])], dim=1)
        return states.replace(step_count=ag[:, A_CNT].contiguous(),
                              carrying=carrying.to(torch.uint8))
