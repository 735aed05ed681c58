"""The program's states and outputs as the reference reads them: NumPy
dicts in the reference's layout (``perfbench/reference/minigrid.py``).

Only public dataclass fields and dict keys of the program's states are
read; nothing here calls into the program.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch


def to_np(x):
    """Tensors (or dicts / dataclasses of them) -> NumPy, int64 for ints."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    a = x.detach().cpu().numpy()
    if a.dtype.kind in "iu":
        return a.astype(np.int64)
    return a


def packed(triples: np.ndarray) -> np.ndarray:
    """(..., 3) triples -> packed words."""
    t = triples.astype(np.int64)
    return t[..., 0] | (t[..., 1] << 8) | (t[..., 2] << 16)


ENV_FIELDS = ("grid", "box_contains", "agent_pos", "agent_dir", "carrying",
              "carrying_contains", "step_count", "terminated", "truncated", "rng",
              "mission", "max_steps", "extra")


def take_rows(envs, idx) -> SimpleNamespace:
    """Rows ``idx`` (NumPy ints) of an ``EnvState`` batch, on its device."""
    i = torch.as_tensor(np.asarray(idx, np.int64), device=envs.grid.device)

    def pick(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: pick(v) for k, v in x.items()}
        return x.index_select(0, i)

    return SimpleNamespace(**{f: pick(getattr(envs, f)) for f in ENV_FIELDS})


def rows_changed(a, b, idx) -> np.ndarray:
    """bool[len(idx)]: rows ``idx`` where two ``EnvState`` batches differ in
    any field, compared on their device."""
    i = torch.as_tensor(np.asarray(idx, np.int64), device=a.grid.device)
    out = torch.zeros(i.shape, dtype=torch.bool, device=i.device)

    def walk(x, y):
        nonlocal out
        if x is None:
            return
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
            return
        d = x.index_select(0, i) != y.index_select(0, i)
        out |= d.reshape(d.shape[0], -1).any(1)

    for f in ENV_FIELDS:
        walk(getattr(a, f), getattr(b, f))
    return to_np(out)


def env_levels(envs) -> dict:
    """An ``EnvState`` batch (or :func:`take_rows` of one) -> the
    reference's level dict."""
    s = {f: to_np(getattr(envs, f)) for f in ENV_FIELDS}
    out = {
        "grid": s["grid"], "pos": s["agent_pos"], "dir": s["agent_dir"],
        "carrying": packed(s["carrying"]), "step_count": s["step_count"],
        "max_steps": s["max_steps"], "rng": s["rng"], "mission": s["mission"],
        "terminated": s["terminated"], "truncated": s["truncated"],
    }
    if s["box_contains"] is not None:
        out["box"] = s["box_contains"]
        out["carrying_box"] = packed(s["carrying_contains"])
    if s["extra"] is not None:
        out["extra"] = s["extra"]
    return out


def ring(state) -> dict:
    """A ``PooledState``'s ring bookkeeping: fresh flags, tick, key and the
    served counters (the levels stay on the device)."""
    return {"fresh": to_np(state.fresh), "tick": int(state.tick),
            "key": to_np(state.key), "n_fresh": int(state.n_fresh),
            "n_stale": int(state.n_stale)}


def concat(a: dict, b: dict) -> dict:
    if isinstance(a, dict):
        return {k: concat(a[k], b[k]) for k in a}
    return np.concatenate([a, b])


# the fused engine's agent columns: x, y, dir, step count, carried type, color
A_X, A_Y, A_DIR, A_CNT, A_CTYP, A_CCOL = range(6)


def fused(fs: dict) -> dict:
    """The fused engine's planes -> a level dict plus its key and step
    index."""
    ag = to_np(fs["agent"])
    return {"grid": to_np(fs["grid"]), "pos": ag[:, [A_X, A_Y]], "dir": ag[:, A_DIR],
            "step_count": ag[:, A_CNT],
            "carrying": ag[:, A_CTYP] | (ag[:, A_CCOL] << 8),
            "spare": ag[:, 6:], "key": to_np(fs["rng"]), "t": int(fs["t"]),
            "mission": to_np(fs["mission"])}


def obs(o: dict) -> dict:
    return {k: to_np(v) for k, v in o.items()}


def rows_differ(a, b) -> np.ndarray:
    """bool[B]: where two level dicts (same structure, leading dim B) differ
    in any field."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise KeyError(f"fields differ: {sorted(set(a) ^ set(b))}")
        out = None
        for k in a:
            d = rows_differ(a[k], b[k])
            out = d if out is None else out | d
        return out
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return np.ones(a.shape[0] if a.ndim else 1, bool)
    if a.ndim == 1:
        return a != b
    return (a != b).reshape(a.shape[0], -1).any(1)
