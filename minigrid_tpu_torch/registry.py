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


def make_vec(id: str, num_envs: int, *, params=None, auto_reset: bool = True,
             final_obs: bool = False, reset_strategy: str | None = None,
             pool_refill: int | None = None, strict_refill: bool = False,
             device=None, **overrides: Any):
    """A ``VectorEnv`` of ``num_envs`` lockstep instances of the preset, on
    ``device`` (CUDA unless named).  The reset strategy and the refill window
    default to the family's, as in the JAX package; env-constructor
    overrides pass through ``**overrides``."""
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    return VectorEnv(make(id, **overrides), num_envs, params,
                     auto_reset=auto_reset, final_obs=final_obs,
                     reset_strategy=reset_strategy, pool_refill=pool_refill,
                     strict_refill=strict_refill, device=device)


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)


def spec(id: str) -> EnvSpec:
    """The registered (class, preset kwargs) of ``id``."""
    return _REGISTRY[id]
