"""State carried across between the JAX package and the port, as numpy.

``state_from_numpy`` takes a state given as numpy arrays keyed by the field
names of ``EnvState`` (or of ``PooledState``, with ``envs``/``pool`` as nested
dicts) and returns the port's state on a device; ``state_to_numpy`` goes the
other way, in the JAX package's dtypes (packed grids and PRNG keys as
uint32).  The port never sees a JAX object: the caller turns a JAX pytree
into such a dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minigrid_tpu_torch.core.state import EnvState, resolve_device
from minigrid_tpu_torch.parallel.vector import PooledState

_ENV_DTYPES = {
    "grid": torch.int32,
    "box_contains": torch.int32,
    "agent_pos": torch.int32,
    "agent_dir": torch.int32,
    "carrying": torch.uint8,
    "carrying_contains": torch.uint8,
    "step_count": torch.int32,
    "terminated": torch.bool,
    "truncated": torch.bool,
    "rng": torch.int64,
    "mission": torch.int32,
    "max_steps": torch.int32,
}
_POOL_DTYPES = {
    "fresh": torch.bool,
    "tick": torch.int32,
    "key": torch.int64,
    "n_fresh": torch.int32,
    "n_stale": torch.int32,
}
# Fields the JAX package holds as uint32: packed words and key words.
_UINT32 = {"grid", "box_contains", "rng", "key"}


def _to_tensor(name: str, value, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(value).astype(np.int64)  # lossless for every field
    if dtype == torch.int32 and arr.size and arr.max() > np.iinfo(np.int32).max:
        raise ValueError(f"{name} holds values above int32")
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _convert(fields: dict, dtypes: dict, device) -> dict:
    extra = [k for k, v in fields.items() if k not in dtypes and v is not None]
    if extra:
        raise ValueError(f"fields the port does not carry: {sorted(extra)}")
    return {k: None if fields.get(k) is None else _to_tensor(k, fields[k], dt, device)
            for k, dt in dtypes.items()}


def state_from_numpy(fields: dict, device=None):
    """numpy fields -> ``EnvState``, or ``PooledState`` when ``fields`` has
    ``envs``/``pool``.  Absent box planes are ``None``."""
    dev = resolve_device(device)
    if "envs" in fields:
        rest = {k: v for k, v in fields.items() if k not in ("envs", "pool")}
        return PooledState(envs=state_from_numpy(fields["envs"], dev),
                           pool=state_from_numpy(fields["pool"], dev),
                           **_convert(rest, _POOL_DTYPES, dev))
    return EnvState(**_convert(fields, _ENV_DTYPES, dev))


def state_to_numpy(state) -> dict:
    """``EnvState``/``PooledState`` -> numpy fields in the JAX package's
    dtypes."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, EnvState):
            out[f.name] = state_to_numpy(v)
        elif v is None:
            out[f.name] = None
        else:
            arr = v.detach().cpu().numpy()
            out[f.name] = arr.astype(np.uint32) if f.name in _UINT32 else arr
    return out
