"""Environment registry: id -> (env class, preset kwargs).

Counterpart of ``minigrid_tpu/registry.py``, with the reference's id strings:

    venv = minigrid_tpu_torch.make_vec("MiniGrid-DoorKey-8x8-v0", 4096,
                                       reset_strategy="pooled", pool_refill=64)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Type

from minigrid_tpu_torch.core.env import Env


@dataclass
class EnvSpec:
    id: str
    cls: Type[Env]
    kwargs: dict[str, Any] = field(default_factory=dict)


_REGISTRY: dict[str, EnvSpec] = {}


def register(id: str, cls: Type[Env], **kwargs: Any) -> None:
    _REGISTRY[id] = EnvSpec(id=id, cls=cls, kwargs=dict(kwargs))


def make(id: str, **overrides: Any) -> Env:
    """Instantiate a registered env preset (the gym.make analogue)."""
    if id not in _REGISTRY:
        raise KeyError(f"Unknown env id {id!r}. Known ids: {sorted(_REGISTRY)}")
    spec = _REGISTRY[id]
    return spec.cls(**{**spec.kwargs, **overrides})


def make_vec(id: str, num_envs: int, *, params=None,
             reset_strategy: str | None = None, pool_refill: int | None = None,
             device=None, **overrides: Any):
    """A ``VectorEnv`` of ``num_envs`` lockstep instances of the preset, on
    ``device`` (CUDA unless named).  Env-constructor overrides pass through
    ``**overrides``."""
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    return VectorEnv(make(id, **overrides), num_envs, params,
                     reset_strategy=reset_strategy, pool_refill=pool_refill,
                     device=device)


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)
