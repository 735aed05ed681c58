"""Gymnasium interop: the reference's user-facing API over the port's engine.

Counterpart of ``minigrid_tpu/gym_compat.py``.  :class:`GymEnv` adapts any
functional :class:`minigrid_tpu_torch.core.env.Env` to the Gymnasium API
(reset/step/render/pickle, numpy observations, mission *strings*) over a
batch of one env on a device (CUDA unless ``device`` names another), and
:func:`register_gym_envs` installs every registered id into the Gymnasium
registry under the port's namespace, ``minigrid_tpu_torch/<id>`` (the bare
ids belong to the JAX package's adapter)::

    import gymnasium as gym
    import minigrid_tpu_torch.gym_compat as gc
    gc.register_gym_envs()
    env = gym.make("minigrid_tpu_torch/MiniGrid-DoorKey-8x8-v0", exact_seed=True)
    obs, info = env.reset(seed=0)      # the reference's level for seed 0
    obs, r, term, trunc, info = env.step(env.action_space.sample())

``exact_seed=True`` replays the reference's ``np_random`` call order on the
host (``utils/exact.py``), so ``reset(seed=s)`` gives the level
``ref_env.reset(seed=s)`` gives; otherwise a reset draws from the threefry
key stream of the JAX adapter (``key = PRNGKey(seed)``, then ``key, k =
split(key)`` a reset).  Each step reads its outputs back in one copy.  The
adapter is a host-side convenience for interactive use, evaluation and
conformance testing; training should drive ``VectorEnv`` directly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

import gymnasium as gym
from gymnasium import spaces

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.grid_ops import unpack_np
from minigrid_tpu_torch.core.mission import BabyAIMissionSpace, MissionSpace
from minigrid_tpu_torch.core.state import map_fields
from minigrid_tpu_torch.registry import registered_ids
from minigrid_tpu_torch.single_env import SingleEnv

NAMESPACE = "minigrid_tpu_torch"


class GymEnv(SingleEnv, gym.Env):
    """Stateful Gymnasium adapter over a functional env.

    :class:`SingleEnv`'s ``reset``/``step`` (the env's batch methods on a
    batch of one, numpy observations with the mission detokenized to the
    reference's string surface, minigrid_env.py:645-651 obs dict) under
    ``gymnasium.Env``, with the spaces, rendering and pickling."""

    metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 10}

    def __init__(self, env: Env | str, render_mode: str | None = None,
                 exact_seed: bool = False, device=None, **kwargs: Any):
        super().__init__(env, exact_seed=exact_seed, device=device, **kwargs)
        self.render_mode = render_mode
        self._window = None
        self._build_spaces()
        self.reward_range = (0.0, 1.0)

    def _build_spaces(self) -> None:
        v = self.params.agent_view_size
        # Grammar-mission envs (BabyAI) declare an accept-all space, like
        # the reference's BabyAIMissionSpace (roomgrid_level.py:26-42);
        # template envs enumerate their mission strings from mission_codes().
        if getattr(self.fenv, "grammar_missions", False):
            mission_space = BabyAIMissionSpace(mission_func=_FixedMission(self.fenv))
        else:
            mission_space = _EnumMissionSpace(self.fenv)
        self.observation_space = spaces.Dict(
            {
                "image": spaces.Box(0, 255, (v, v, 3), dtype=np.uint8),
                "direction": spaces.Discrete(4),
                "mission": mission_space,
            }
        )
        self.action_space = spaces.Discrete(self.fenv.num_actions)

    # -- gym protocol ---------------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        gym.Env.reset(self, seed=seed)
        out = super().reset(seed=seed, options=options)
        if self.render_mode == "human":
            self.render()
        return out

    def step(self, action):
        out = super().step(action)
        if self.render_mode == "human":
            self.render()
        return out

    def render(self):
        frame = self.fenv.get_frame(self._state, self.params, highlight=True)[0]
        frame = frame.cpu().numpy()
        if self.render_mode == "human":
            from minigrid_tpu_torch.utils.window import Window

            if self._window is None:
                self._window = Window(getattr(self.fenv, "name", "minigrid-tpu-torch"))
                self._window.show(block=False)
            self._window.show_img(frame)
            return None
        return frame

    def close(self):
        if self._window is not None:
            self._window.close()
            self._window = None

    # -- helpers ---------------------------------------------------------------
    @property
    def unwrapped(self):
        return self

    # convenience passthroughs reference users rely on
    @property
    def agent_pos(self):
        return tuple(int(v) for v in self._state.agent_pos[0].cpu())

    @property
    def agent_dir(self):
        return int(self._state.agent_dir[0])

    @property
    def carrying(self):
        return self._state.carrying[0].cpu().numpy()

    @property
    def max_steps(self):
        return self.params.max_steps

    def hash(self, size: int = 16) -> str:
        """State digest (MiniGridEnv.hash, minigrid_env.py:166-176): the JAX
        adapter's ``hash`` of the same state, i.e. of env 0 with the batch
        dim dropped."""
        from minigrid_tpu_torch.utils.checkpoint import state_hash

        return state_hash(map_fields(lambda t: t[0], self._state), size)

    # -- view geometry (MiniGridEnv, minigrid_env.py:396-522) -----------------
    @property
    def dir_vec(self):
        return np.asarray(C.DIR_TO_VEC[self.agent_dir])

    @property
    def right_vec(self):
        dx, dy = self.dir_vec
        return np.array((-dy, dx))

    @property
    def front_pos(self):
        return np.asarray(self.agent_pos) + self.dir_vec

    @property
    def steps_remaining(self):
        return self.max_steps - int(self._state.step_count[0])

    @property
    def grid(self) -> np.ndarray:
        """Full-grid encode, (W, H, 3) uint8: the reference's
        ``grid.encode()`` surface (the engine stores packed words; this
        unpacks at the host boundary)."""
        return unpack_np(self._state.grid[0].cpu().numpy())

    def get_view_coords(self, i, j):
        """World (i, j) -> agent-view coordinates (minigrid_env.py:425-450);
        results may fall outside [0, view_size)."""
        ax, ay = self.agent_pos
        dx, dy = self.dir_vec
        rx, ry = self.right_vec
        sz = self.params.agent_view_size
        hs = sz // 2
        tx = ax + (dx * (sz - 1)) - (rx * hs)
        ty = ay + (dy * (sz - 1)) - (ry * hs)
        lx, ly = i - tx, j - ty
        return rx * lx + ry * ly, -(dx * lx + dy * ly)

    def relative_coords(self, x, y):
        """(vx, vy) if inside the view else None (minigrid_env.py:484-495)."""
        vx, vy = self.get_view_coords(x, y)
        v = self.params.agent_view_size
        if vx < 0 or vy < 0 or vx >= v or vy >= v:
            return None
        return int(vx), int(vy)

    def in_view(self, x, y) -> bool:
        return self.relative_coords(x, y) is not None

    def agent_sees(self, x, y) -> bool:
        """Non-empty world cell (x, y) visible in the current obs
        (minigrid_env.py:505-522)."""
        coords = self.relative_coords(x, y)
        if coords is None:
            return False
        vx, vy = coords
        from minigrid_tpu_torch.core.obs import gen_obs_batch

        obs = gen_obs_batch(self._state, self.params)
        obs_type = int(obs["image"][0, vx, vy, 0])
        world_type = int(self._state.grid[0, x, y] & 0xFF)
        # reference: decoded obs cell is not None (i.e. a real object) and
        # its type equals the world cell's
        hidden = (C.OBJECT_TO_IDX["unseen"], C.OBJECT_TO_IDX["empty"])
        return obs_type == world_type and obs_type not in hidden

    def __str__(self) -> str:
        """2-chars-per-cell ASCII map (MiniGridEnv.__str__,
        minigrid_env.py:182-233)."""
        obj_str = {"wall": "W", "floor": "F", "door": "D", "key": "K",
                   "ball": "A", "box": "B", "goal": "G", "lava": "V"}
        idx_to_obj = {v: k for k, v in C.OBJECT_TO_IDX.items()}
        idx_to_color = {v: k for k, v in C.COLOR_TO_IDX.items()}
        dir_str = {0: ">", 1: "V", 2: "<", 3: "^"}
        g = self.grid
        w, h = g.shape[:2]
        ax, ay = self.agent_pos
        rows = []
        for j in range(h):
            row = ""
            for i in range(w):
                if (i, j) == (ax, ay):
                    row += 2 * dir_str[self.agent_dir]
                    continue
                t, c, s = (int(v) for v in g[i, j])
                name = idx_to_obj.get(t, "?")
                if name == "empty":
                    row += "  "
                    continue
                color0 = idx_to_color.get(c, "?")[:1].upper()
                if name == "door":
                    row += ("__" if s == C.STATE_TO_IDX["open"]
                            else ("L" if s == C.STATE_TO_IDX["locked"]
                                  else "D") + color0)
                    continue
                row += obj_str.get(name, name[:1].upper()) + color0
            rows.append(row)
        return "\n".join(rows)

    # pickling: the state and key travel as host numpy and come back on the
    # adapter's device; the window and the spaces are rebuilt on load
    def __getstate__(self):
        from minigrid_tpu_torch.utils.convert import state_to_numpy

        d = self.__dict__.copy()
        d["_state"] = None if self._state is None else state_to_numpy(self._state)
        d["_key"] = self._key.cpu().numpy()
        d["device"] = str(self.device)
        for k in ("_window", "observation_space", "action_space"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        from minigrid_tpu_torch.utils.convert import state_from_numpy

        self.__dict__.update(d)
        self.device = torch.device(d["device"])
        if d["_state"] is not None:
            self._state = state_from_numpy(d["_state"], self.device)
        self._key = torch.from_numpy(d["_key"]).to(self.device)
        self._window = None
        self._build_spaces()


class _EnumMissionSpace(MissionSpace):
    """Mission space enumerated from ``Env.mission_codes``.

    ``contains`` accepts exactly the strings the env can emit and ``sample``
    draws uniformly over them: the reference's template x placeholder
    MissionSpace declaration for the same env, behaviourally."""

    def __init__(self, fenv: Env):
        self._strings = list(
            dict.fromkeys(fenv.mission_text(np.asarray(c)) for c in fenv.mission_codes())
        )
        super().__init__(mission_func=_ConstMission(self._strings[0]))

    def sample(self) -> str:
        return self._strings[int(self.np_random.integers(len(self._strings)))]

    def contains(self, x) -> bool:
        return isinstance(x, str) and x in self._strings


class _ConstMission:
    """Picklable zero-arg mission function returning a fixed string."""

    def __init__(self, s: str):
        self.s = s

    @property
    def __code__(self):
        return (lambda: None).__code__

    def __call__(self) -> str:
        return self.s


class _FixedMission:
    """Picklable zero-arg mission sampler for the space declaration (the
    mission distribution is env-internal; the space's sample() surfaces a
    representative string, as reference envs declare MissionSpace from
    static templates, e.g. envs/doorkey.py:55-60)."""

    def __init__(self, fenv: Env):
        self.fenv = fenv

    # MissionSpace checks co_argcount == 0 for template-free spaces; a
    # __call__ method has argcount 1 (self), so expose a zero-arg code.
    @property
    def __code__(self):
        return (lambda: None).__code__

    def __call__(self) -> str:
        return self.fenv.mission_text(np.asarray(self.fenv.mission_codes()[0]))


def gym_id(env_id: str) -> str:
    """The port's Gymnasium id of a registered id."""
    return f"{NAMESPACE}/{env_id}"


def register_gym_envs(force: bool = False) -> int:
    """Register every registered id with Gymnasium as
    ``minigrid_tpu_torch/<id>``; returns the number of ids registered (0
    when all are registered already, unless ``force``)."""
    count = 0
    for env_id in registered_ids():
        name = gym_id(env_id)
        if name in gym.registry and not force:
            continue
        gym.register(id=name, entry_point=_Entry(env_id), disable_env_checker=True)
        count += 1
    return count


class _Entry:
    """Picklable entry point for one registered id (env.spec must survive
    pickling of made envs, reference test_envs.py:168-183)."""

    def __init__(self, env_id: str):
        self.env_id = env_id

    def __call__(self, render_mode: str | None = None, **kwargs: Any) -> GymEnv:
        return GymEnv(self.env_id, render_mode=render_mode, **kwargs)
