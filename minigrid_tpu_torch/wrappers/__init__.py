"""Observation and reward wrappers, batch-first.

Counterpart of ``minigrid_tpu/wrappers/__init__.py`` (the reference's 15
wrapper classes, minigrid/wrappers.py:16-569).  Each wrapper is itself an
:class:`Env` over a batch: observation wrappers rewrite the observation of
every env at once, the exploration bonuses extend the state with their count
tables (:class:`BonusState`), and the mission-tokenizing wrappers precompute
their encodings on the host over the env's mission-code table, so that a step
only gathers rows of a table on the device.

Every wrapper composes with :class:`minigrid_tpu_torch.parallel.vector.VectorEnv`,
which reads the wrapped family's reset-strategy attributes through
:class:`Wrapper`'s delegation, as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.grid_ops import pack_word, unpack_cells
from minigrid_tpu_torch.core.obs import gen_obs_batch
from minigrid_tpu_torch.core.state import EnvParams, EnvState
from minigrid_tpu_torch.core.step import NUM_ACTIONS


class Wrapper(Env):
    """Base: delegates everything to the wrapped env."""

    def __init__(self, env: Env):
        self.env = env

    def __getattr__(self, name):
        if name == "env":  # not yet set: no recursion through self.env
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def default_params(self) -> EnvParams:
        return self.env.default_params

    def generate(self, keys, params, device=None):
        return self.env.generate(keys, params, device)

    def reset(self, keys, params, device=None):
        state = self.generate(keys, params, device)
        return self.observation(state, params), state

    def step_state(self, state, action, params):
        return self.env.step_state(state, action, params)

    def step(self, state, action, params):
        state, reward, terminated, truncated = self.step_state(state, action, params)
        return (self.observation(state, params), state, reward, terminated,
                truncated, {})

    def observation(self, states, params):
        return self.env.observation(states, params)


class ObservationWrapper(Wrapper):
    """Rewrites observations; override :meth:`transform`."""

    def observation(self, states, params):
        return self.transform(self.env.observation(states, params), states, params)

    def transform(self, obs, states, params):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------


class ReseedWrapper(Wrapper):
    """Cycle a fixed seed list on reset (wrappers.py:16-34).  The cycle index
    is host state, like the reference's attribute; each reset returns a batch
    of one env, the level the JAX package's reset gives for that seed."""

    def __init__(self, env: Env, seeds=(0,), seed_idx: int = 0):
        super().__init__(env)
        self.seeds = list(seeds)
        self.seed_idx = seed_idx

    def reset(self, keys=None, params=None, device=None):
        params = params if params is not None else self.default_params
        seed = self.seeds[self.seed_idx]
        self.seed_idx = (self.seed_idx + 1) % len(self.seeds)
        return self.env.reset(rng.PRNGKey(seed, device)[None], params, device)


# ---------------------------------------------------------------------------
# Exploration bonuses — counts live beside the env state
# ---------------------------------------------------------------------------


@dataclass
class BonusState:
    """An ``EnvState`` batch and its per-env count table (leading dim B)."""

    inner: EnvState
    counts: torch.Tensor  # int32[B, ...count shape]

    # pass-through, so the batch engine regenerates from the env's stream
    @property
    def rng(self) -> torch.Tensor:
        return self.inner.rng

    @property
    def step_count(self) -> torch.Tensor:
        return self.inner.step_count

    def replace(self, **changes) -> "BonusState":
        return dataclasses.replace(self, **changes)


class _BonusWrapper(Wrapper):
    """Shared machinery: reward += 1/sqrt(N(key)) with N a count table."""

    def _count_shape(self, params) -> tuple:
        raise NotImplementedError

    def _index(self, state: EnvState, action) -> tuple:
        raise NotImplementedError

    def generate(self, keys, params, device=None):
        inner = self.env.generate(keys, params, device)
        counts = torch.zeros((inner.grid.shape[0],) + self._count_shape(params),
                             dtype=torch.int32, device=inner.grid.device)
        return BonusState(inner=inner, counts=counts)

    def step_state(self, state: BonusState, action, params):
        inner, reward, terminated, truncated = self.env.step_state(
            state.inner, action, params)
        # one scatter-add at each env's post-step index (JAX's masked select
        # over the whole table is a TPU workaround)
        b = state.counts.shape[0]
        shape = state.counts.shape[1:]
        flat = torch.zeros((b,), dtype=torch.int64, device=state.counts.device)
        for size, i in zip(shape, self._index(inner, action)):
            flat = flat * size + i.to(torch.int64)
        counts = state.counts.reshape(b, -1).clone()
        counts.scatter_add_(1, flat[:, None], torch.ones((b, 1), dtype=torch.int32,
                                                         device=counts.device))
        new_count = counts.gather(1, flat[:, None])[:, 0]
        bonus = 1.0 / torch.sqrt(new_count.to(torch.float32))
        return (BonusState(inner=inner, counts=counts.reshape(state.counts.shape)),
                reward + bonus, terminated, truncated)

    def observation(self, states: BonusState, params):
        return self.env.observation(states.inner, params)


class ActionBonus(_BonusWrapper):
    """1/sqrt(N(pos, dir, action)) exploration bonus (wrappers.py:37-69).
    Counts are per episode under the batch engine's auto-reset."""

    def _count_shape(self, params):
        return (params.width, params.height, 4, NUM_ACTIONS)

    def _index(self, state: EnvState, action):
        return (state.agent_pos[:, 0], state.agent_pos[:, 1], state.agent_dir,
                torch.as_tensor(action, device=state.agent_dir.device))


class StateBonus(_BonusWrapper):
    """1/sqrt(N(pos)) exploration bonus (wrappers.py:72-105)."""

    def _count_shape(self, params):
        return (params.width, params.height)

    def _index(self, state: EnvState, action):
        return (state.agent_pos[:, 0], state.agent_pos[:, 1])


# ---------------------------------------------------------------------------
# Pure observation transforms
# ---------------------------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot by compare: an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises)."""
    classes = torch.arange(n, device=idx.device)
    return (idx.to(torch.int64)[..., None] == classes).to(dtype)


_AGENT_RED = (C.OBJECT_TO_IDX["agent"], C.COLOR_TO_IDX["red"])


def _full_image(states: EnvState) -> torch.Tensor:
    """The whole grid encoded, uint8[B, W, H, 3], with the agent's cell
    stamped (agent, red, dir)."""
    b = states.grid.shape[0]
    ar = torch.arange(b, device=states.grid.device)
    word = pack_word((*_AGENT_RED, 0)) | (states.agent_dir << 16)
    full = states.grid.clone()
    full[ar, states.agent_pos[:, 0].long(), states.agent_pos[:, 1].long()] = word
    return unpack_cells(full)


class ImgObsWrapper(ObservationWrapper):
    """Image-only obs (wrappers.py:108-118)."""

    def transform(self, obs, states, params):
        return obs["image"]


class OneHotPartialObsWrapper(ObservationWrapper):
    """Per-cell one-hot of (type, color, state) -> uint8[B, V, V, 47]
    (wrappers.py:121-158).  The color gets 10 classes, as in the reference,
    so orange (10) is a zero row."""

    NUM_BITS = C.NUM_OBJECT_TYPES + 10 + 3  # 34 + 10 + 3 = 47 (wrappers.py:135)

    def transform(self, obs, states, params):
        img = obs["image"]
        parts = [_one_hot(img[..., 0], C.NUM_OBJECT_TYPES, torch.uint8),
                 _one_hot(img[..., 1], 10, torch.uint8),
                 _one_hot(img[..., 2], 3, torch.uint8)]
        return {**obs, "image": torch.cat(parts, dim=-1)}


class FullyObsWrapper(ObservationWrapper):
    """Full-grid encode with the agent cell stamped (agent, red, dir)
    (wrappers.py:219-255)."""

    def transform(self, obs, states, params):
        return {**obs, "image": _full_image(states)}


class SymbolicObsWrapper(ObservationWrapper):
    """(x, y, type) triples over the full grid, -1 for empty cells, the agent
    cell stamped with the agent id (wrappers.py:538-569): int32[B, W, H, 3]."""

    def transform(self, obs, states, params):
        b, w, h = states.grid.shape
        dev = states.grid.device
        xs = torch.arange(w, dtype=torch.int32, device=dev)[:, None].expand(w, h)
        ys = torch.arange(h, dtype=torch.int32, device=dev)[None, :].expand(w, h)
        t = states.grid & 0xFF
        t = torch.where(t == C.OBJECT_TO_IDX["empty"], -1, t)
        at_agent = ((xs == states.agent_pos[:, 0, None, None])
                    & (ys == states.agent_pos[:, 1, None, None]))
        t = torch.where(at_agent, C.OBJECT_TO_IDX["agent"], t)
        return {**obs, "image": torch.stack([xs.expand(b, w, h), ys.expand(b, w, h), t],
                                            dim=-1)}


class RGBImgObsWrapper(ObservationWrapper):
    """Fully observable RGB pixel obs (wrappers.py:161-186): the whole grid
    rendered with the agent's view highlighted, uint8[B, H*T, W*T, 3]."""

    def __init__(self, env: Env, tile_size: int = 8):
        super().__init__(env)
        self.tile_size = tile_size
        from minigrid_tpu_torch.ops.render import atlas_np

        atlas_np(tile_size)  # built on the host now, moved on first use

    def transform(self, obs, states, params):
        from minigrid_tpu_torch.ops.render import full_render, get_atlas

        atlas = get_atlas(self.tile_size, states.grid.device)
        return {**obs, "image": full_render(states, params, atlas, highlight=True)}


class RGBImgPartialObsWrapper(ObservationWrapper):
    """Partially observable RGB pixel obs (wrappers.py:189-216): the agent's
    POV rendered at ``tile_size`` pixels a cell, uint8[B, V*T, V*T, 3].

    ``channels_first=True`` serves uint8[B, 3, V*T, V*T] on the batched path
    (:meth:`observation_batch`, what ``VectorEnv`` calls); :meth:`observation`
    stays in the reference's layout, as the JAX per-env one does."""

    def __init__(self, env: Env, tile_size: int = 8, channels_first: bool = False):
        super().__init__(env)
        self.tile_size = tile_size
        self.channels_first = channels_first
        from minigrid_tpu_torch.ops.render import atlas_np

        atlas_np(tile_size)

    def transform(self, obs, states, params):
        from minigrid_tpu_torch.ops.render import get_atlas, pov_render

        atlas = get_atlas(self.tile_size, states.grid.device)
        return {**obs, "image": pov_render(states, params, atlas)}

    def observation_batch(self, states, params):
        from minigrid_tpu_torch.ops.render import get_atlas, pov_render_batch

        base = self.env.observation_batch(states, params)
        atlas = get_atlas(self.tile_size, states.grid.device)
        return {**base, "image": pov_render_batch(states, params, atlas,
                                                  channels_first=self.channels_first)}


class ViewSizeWrapper(Wrapper):
    """Re-run the observation at a custom view size (wrappers.py:469-501):
    the window, occlusion and overlay at that size, from one more
    ``obs_gather`` launch."""

    def __init__(self, env: Env, agent_view_size: int = 7):
        super().__init__(env)
        if agent_view_size % 2 != 1 or agent_view_size < 3:
            raise ValueError("agent_view_size must be odd and >= 3")
        self.agent_view_size = agent_view_size

    def observation(self, states, params):
        obs = self.env.observation(states, params)
        view_params = dataclasses.replace(params, agent_view_size=self.agent_view_size)
        return {**obs, "image": gen_obs_batch(states, view_params)["image"]}


def _first_goal(states: EnvState) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gy, found): the first goal cell in x-major order, int32[B]
    each; (0, 0) and found False when the grid has none."""
    b, w, h = states.grid.shape
    is_goal = ((states.grid & 0xFF) == C.OBJECT_TO_IDX["goal"]).reshape(b, w * h)
    flat = is_goal.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return flat // h, flat % h, is_goal.any(dim=1)


class DirectionObsWrapper(ObservationWrapper):
    """Slope (or angle) toward the first goal cell, float32[B]
    (wrappers.py:504-535; the reference's row/column index bug at :524-526
    fixed, as in the JAX package).  With no goal the goal reads as (0, 0)."""

    def __init__(self, env: Env, type: str = "slope"):
        super().__init__(env)
        self.type = type

    def transform(self, obs, states, params):
        gx, gy, _ = _first_goal(states)
        slope = ((gy - states.agent_pos[:, 1]).to(torch.float32)
                 / (gx - states.agent_pos[:, 0]).to(torch.float32))
        direction = torch.atan(slope) if self.type == "angle" else slope
        return {**obs, "goal_direction": direction}


# ---------------------------------------------------------------------------
# Mission tokenizing wrappers — precomputed over the mission-code table
# ---------------------------------------------------------------------------


class _MissionTable:
    """A host table with one row per mission code, moved to a device once;
    a batch of missions looks up its rows by exact code match."""

    def __init__(self, codes: np.ndarray, rows: np.ndarray):
        self._np = {"codes": np.asarray(codes, dtype=np.int32), "rows": rows}
        self._dev: dict[str, dict] = {}

    def rows(self, mission: torch.Tensor) -> torch.Tensor:
        key = str(mission.device)
        if key not in self._dev:
            self._dev[key] = {k: torch.from_numpy(v).to(mission.device)
                              for k, v in self._np.items()}
        t = self._dev[key]
        return t["rows"].index_select(0, _mission_lookup(t["codes"], mission))


def _mission_lookup(codes: torch.Tensor, mission: torch.Tensor) -> torch.Tensor:
    """Row of each env's mission int32[B, M] in the code table int32[N, M]:
    the first row that matches in every column, row 0 when none does."""
    match = (codes[None, :, :] == mission[:, None, :]).all(dim=2)
    return match.to(torch.uint8).argmax(dim=1)


class DictObservationSpaceWrapper(ObservationWrapper):
    """Mission -> padded word-index array with the built-in MiniGrid vocab
    (wrappers.py:286-403), int32[B, max_words_in_mission].  Word arrays are
    precomputed per mission code; a mission outside the vocabulary (the
    fork's palette has 10 colors, the vocabulary 6) is the all-zero row."""

    def __init__(self, env: Env, max_words_in_mission: int = 50, word_dict=None):
        super().__init__(env)
        self.max_words_in_mission = max_words_in_mission
        self.word_dict = word_dict or self.get_minigrid_words()
        codes = env.mission_codes()
        rows = []
        for code in codes:
            try:
                idx = self.string_to_indices(env.mission_text(code))
            except ValueError:
                idx = []
            assert len(idx) < max_words_in_mission
            rows.append(idx + [0] * (max_words_in_mission - len(idx)))
        self._table = _MissionTable(codes, np.asarray(rows, dtype=np.int32))

    @staticmethod
    def get_minigrid_words():
        """The reference vocabulary (wrappers.py:324-382)."""
        colors = ["red", "green", "blue", "yellow", "purple", "grey"]
        objects = ["unseen", "empty", "wall", "floor", "box", "key", "ball",
                   "door", "goal", "agent", "lava"]
        verbs = ["pick", "avoid", "get", "find", "put", "use", "open", "go",
                 "fetch", "reach", "unlock", "traverse"]
        extra_words = ["up", "the", "a", "at", ",", "square", "and", "then",
                       "to", "of", "rooms", "near", "opening", "must", "you",
                       "matching", "end", "hallway", "object", "from", "room"]
        all_words = colors + objects + verbs + extra_words
        assert len(all_words) == len(set(all_words))
        return {word: i for i, word in enumerate(all_words)}

    def string_to_indices(self, string: str, offset: int = 1) -> list[int]:
        indices = []
        string = string.replace(",", " , ")
        for word in string.split():
            if word in self.word_dict:
                indices.append(self.word_dict[word] + offset)
            else:
                raise ValueError(f"Unknown word: {word}")
        return indices

    def transform(self, obs, states, params):
        return {**obs, "mission": self._table.rows(states.mission)}


class FlatObsWrapper(ObservationWrapper):
    """Flatten image ⊕ one-hot char-encoded mission (wrappers.py:406-466):
    float32[B, V*V*3 + maxStrLen*28].  Char arrays are precomputed per
    mission code."""

    def __init__(self, env: Env, maxStrLen: int = 96):
        super().__init__(env)
        self.maxStrLen = maxStrLen
        self.numCharCodes = 28
        codes = env.mission_codes()
        strs = np.stack([self._encode_str(env.mission_text(code)) for code in codes])
        self._table = _MissionTable(codes, strs)

    def _encode_str(self, mission: str) -> np.ndarray:
        assert len(mission) <= self.maxStrLen, "mission string too long"
        mission = mission.lower()
        out = np.zeros((self.maxStrLen, self.numCharCodes), dtype=np.float32)
        for idx, ch in enumerate(mission):
            if "a" <= ch <= "z":
                ch_no = ord(ch) - ord("a")
            elif ch == " ":
                ch_no = 26
            elif ch == ",":
                ch_no = 27
            else:
                raise ValueError(f"Character {ch} is not available in mission string.")
            out[idx, ch_no] = 1
        return out.flatten()

    def transform(self, obs, states, params):
        img = obs["image"].to(torch.float32).reshape(obs["image"].shape[0], -1)
        return torch.cat([img, self._table.rows(states.mission)], dim=1)


def _goal_cell(states: EnvState) -> torch.Tensor:
    """int32[B, 2]: (x, y) of the first goal cell, or (-1, -1) when the grid
    has none — the ``target_cell`` the fork's wrappers assume."""
    gx, gy, found = _first_goal(states)
    pos = torch.stack([gx, gy], dim=1)
    return torch.where(found[:, None], pos, -1)


def _robot_obs(states: EnvState, *lead: torch.Tensor) -> torch.Tensor:
    """float32[B, ...]: ``lead``, the agent's position, its direction
    one-hot."""
    parts = [t.to(torch.float32) for t in (*lead, states.agent_pos)]
    return torch.cat(parts + [_one_hot(states.agent_dir, 4, torch.float32)], dim=1)


class EasyModeWrapper(ObservationWrapper):
    """Agent pose + goal coordinates, no grid image (wrappers.py:258-271).
    The reference reads ``obs['target_cell']``, a key its own ``gen_obs``
    no longer emits; here the target is the goal cell of the state."""

    def transform(self, obs, states, params):
        target = _goal_cell(states)
        return {
            "mission": obs["mission"],
            "visual_obs": target,
            "robot_obs": _robot_obs(states),
            "target_cell": target,
        }


class NoLanguageWrapper(ObservationWrapper):
    """Full-grid encoding plus the target as coordinates, so no language is
    needed (wrappers.py:273-282; the target recovered as in
    :class:`EasyModeWrapper`)."""

    def transform(self, obs, states, params):
        target = _goal_cell(states)
        return {
            **obs,
            "image": _full_image(states),
            "robot_obs": _robot_obs(states, target),
            "target_cell": target,
        }


__all__ = [
    "Wrapper",
    "ObservationWrapper",
    "ReseedWrapper",
    "ActionBonus",
    "StateBonus",
    "BonusState",
    "ImgObsWrapper",
    "OneHotPartialObsWrapper",
    "RGBImgObsWrapper",
    "RGBImgPartialObsWrapper",
    "FullyObsWrapper",
    "SymbolicObsWrapper",
    "ViewSizeWrapper",
    "DirectionObsWrapper",
    "DictObservationSpaceWrapper",
    "FlatObsWrapper",
    "EasyModeWrapper",
    "NoLanguageWrapper",
]
