"""State carried across between the JAX package and the port, as numpy.

``state_from_numpy`` takes a state given as numpy arrays keyed by the field
names of ``EnvState`` (or of ``PooledState``, with ``envs``/``pool`` as nested
dicts) and returns the port's state on a device; ``state_to_numpy`` goes the
other way, in the JAX package's dtypes (packed grids and PRNG keys as
uint32).  The port never sees a JAX object: the caller turns a JAX pytree
into such a dict.  A bonus wrapper's state (``wrappers.BonusState``) crosses
as ``inner`` (the ``EnvState``'s fields) and ``counts`` (int32).  An
``EnvState``'s ``extra`` is ``None``, an array or a dict of arrays (dicts may
nest; a JAX dataclass there, such as BabyAI's instruction code and verifier
state, crosses as a dict keyed by its field names).  Each leaf keeps its
type: bool stays bool, uint32 (BabyAI's packed verifier planes) is int64 in
the port and uint32 again on the way back, and every other integer leaf is
int32.

``fused_state_from_numpy``/``fused_state_to_numpy`` carry the plane dict of
``FusedVectorEnv`` across: the JAX package keeps its grid as ``[N, LANES]``
rows, ``LANES = max(W*H, V*V)``, whose lanes past ``W*H`` are packed grey
walls; the port keeps ``[N, W, H]``.

``from_reference`` lowers a live reference ``MiniGridEnv`` (its ``grid``,
``agent_pos``, ``agent_dir``, ``carrying`` and ``step_count``) to the
port's state with a batch of one, and ``state_equals_reference`` compares
such a state's world with the reference's, as the JAX package's helpers of
the same names do (``encode_obj`` encodes one reference object).
``to_host`` reads several tensors back to numpy in one copy.

``actor_critic_from_flax``/``actor_critic_to_flax`` and
``recurrent_from_flax``/``recurrent_to_flax`` carry the learner's network
parameters across, bit for bit: the flax trees of ``minigrid_tpu.rl`` as
nested dicts of numpy arrays on one side, the port's ``torch.nn`` modules (or
a dict of tensors keyed by their parameter names, such as gradients) on the
other.  ``shard_params``/``unshard_params`` cut such a dict to one rank's
tensor-parallel slices (``rl.tp_param_sharding``) and put the ranks' slices
back together.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import pack_np, pack_word, unpack_np
from minigrid_tpu_torch.core.rng import PRNGKey
from minigrid_tpu_torch.core.state import EnvState, map_tree, resolve_device
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


def _extra_to_tensor(value, device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    if arr.dtype == np.uint32:
        return _to_tensor("extra", arr, torch.int64, device)
    return _to_tensor("extra", arr, torch.int32, device)


def _extra_to_numpy(t: torch.Tensor) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    if arr.dtype == np.int64:
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError("an int64 extra leaf holds values outside uint32")
        return arr.astype(np.uint32)
    return arr


def state_from_numpy(fields: dict, device=None):
    """numpy fields -> ``EnvState``; ``PooledState`` when ``fields`` has
    ``envs``/``pool``; a bonus wrapper's ``BonusState`` when it has
    ``inner``/``counts``.  Absent box planes and ``extra`` are ``None``."""
    dev = resolve_device(device)
    if "inner" in fields:
        from minigrid_tpu_torch.wrappers import BonusState

        if set(fields) != {"inner", "counts"}:
            raise ValueError(f"a BonusState has inner and counts, got {sorted(fields)}")
        return BonusState(inner=state_from_numpy(fields["inner"], dev),
                          counts=_to_tensor("counts", fields["counts"], torch.int32, dev))
    if "envs" in fields:
        rest = {k: v for k, v in fields.items() if k not in ("envs", "pool")}
        return PooledState(envs=state_from_numpy(fields["envs"], dev),
                           pool=state_from_numpy(fields["pool"], dev),
                           **_convert(rest, _POOL_DTYPES, dev))
    rest = {k: v for k, v in fields.items() if k != "extra"}
    extra = map_tree(lambda v: _extra_to_tensor(v, dev), fields.get("extra"))
    return EnvState(**_convert(rest, _ENV_DTYPES, dev), extra=extra)


def state_to_numpy(state) -> dict:
    """``EnvState``/``PooledState``/``BonusState`` -> numpy fields in the
    JAX package's dtypes."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = state_to_numpy(v)
        elif f.name == "extra":
            out[f.name] = map_tree(_extra_to_numpy, v)
        elif v is None:
            out[f.name] = None
        else:
            arr = v.detach().cpu().numpy()
            out[f.name] = arr.astype(np.uint32) if f.name in _UINT32 else arr
    return out


_FUSED_DTYPES = {
    "grid": torch.int32,
    "agent": torch.int32,
    "rng": torch.int64,
    "t": torch.int32,
    "mission": torch.int32,
}


def fused_state_from_numpy(fields: dict, width: int, height: int,
                           device=None) -> dict:
    """The JAX ``FusedVectorEnv`` planes as numpy (``grid [N, LANES]``,
    ``agent [N, 8]``, ``rng``, ``t``, ``mission``) -> the port's planes on a
    device, the pad lanes dropped."""
    dev = resolve_device(device)
    grid = np.asarray(fields["grid"])
    wh = width * height
    if grid.ndim != 2 or grid.shape[1] < wh:
        raise ValueError(f"grid must be [N, >= {wh}], got {grid.shape}")
    fields = {**fields, "grid": grid[:, :wh].reshape(-1, width, height)}
    return _convert(fields, _FUSED_DTYPES, dev)


def fused_state_to_numpy(fs: dict, lanes: int) -> dict:
    """The port's planes -> numpy in the JAX package's layout and dtypes:
    ``grid`` int32[N, lanes] with the lanes past W*H packed grey walls,
    ``rng`` uint32."""
    out = {k: fs[k].detach().cpu().numpy() for k in _FUSED_DTYPES}
    grid = out["grid"].reshape(out["grid"].shape[0], -1)
    if lanes < grid.shape[1]:
        raise ValueError(f"lanes={lanes} is below the grid's {grid.shape[1]} cells")
    pad = np.full((grid.shape[0], lanes - grid.shape[1]), pack_word(C.WALL_TRIPLE),
                  dtype=np.int32)
    out["grid"] = np.concatenate([grid, pad], axis=1)
    out["rng"] = out["rng"].astype(np.uint32)
    return out


_NUMPY = {torch.uint8: np.uint8, torch.bool: np.bool_, torch.int32: np.int32,
          torch.int64: np.int64, torch.float32: np.float32}


def to_host(tensors) -> list[np.ndarray]:
    """Tensors of one device as numpy arrays through ONE device-to-host
    copy: their bytes packed into one buffer, then viewed back.  Each array
    keeps its tensor's shape and dtype."""
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    blob = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        out.append(blob[at:at + n].view(_NUMPY[f.dtype]).reshape(tuple(t.shape)))
        at += n
    return out


# -- the reference's live envs -------------------------------------------------------

def encode_obj(obj) -> np.ndarray:
    """WorldObj -> (type, color, state) uint8 triple; None -> empty (1,0,0)."""
    if obj is None:
        return np.asarray(C.EMPTY_TRIPLE)
    return np.asarray(obj.encode(), dtype=np.uint8)


def from_reference(ref_env, rng=None, device=None) -> EnvState:
    """Lower a live reference MiniGridEnv to the port's state, a batch of one
    on ``device`` (CUDA unless named); ``rng`` is the state's key, int64[2]
    (default ``PRNGKey(0)``)."""
    dev = resolve_device(device)
    w, h = ref_env.grid.width, ref_env.grid.height
    grid = np.asarray(ref_env.grid.encode(), dtype=np.uint8)
    box_contains = np.broadcast_to(np.asarray(C.EMPTY_TRIPLE), (w, h, 3)).copy()
    for j in range(h):
        for i in range(w):
            cell = ref_env.grid.get(i, j)
            if cell is not None and getattr(cell, "contains", None) is not None:
                box_contains[i, j] = encode_obj(cell.contains)
    carrying = encode_obj(ref_env.carrying)
    carrying_contains = encode_obj(getattr(ref_env.carrying, "contains", None))

    def one(a, dtype):
        return torch.from_numpy(np.asarray(a)[None]).to(device=dev, dtype=dtype)

    key = PRNGKey(0, dev) if rng is None else rng.to(device=dev, dtype=torch.int64)
    return EnvState(
        grid=one(pack_np(grid), torch.int32),
        box_contains=one(pack_np(box_contains), torch.int32),
        agent_pos=one(ref_env.agent_pos, torch.int32),
        agent_dir=one(ref_env.agent_dir, torch.int32),
        carrying=one(carrying, torch.uint8),
        carrying_contains=one(carrying_contains, torch.uint8),
        step_count=one(ref_env.step_count, torch.int32),
        terminated=torch.zeros((1,), dtype=torch.bool, device=dev),
        truncated=torch.zeros((1,), dtype=torch.bool, device=dev),
        rng=key.reshape(1, 2),
        mission=torch.zeros((1, 4), dtype=torch.int32, device=dev),
        max_steps=torch.zeros((1,), dtype=torch.int32, device=dev),
    )


def state_equals_reference(state: EnvState, ref_env) -> bool:
    """World-state comparison of a batch of one with a reference env: grid
    triples, agent pose and carried object."""
    ref_grid = np.asarray(ref_env.grid.encode(), dtype=np.uint8)
    return (
        np.array_equal(unpack_np(state.grid[0].cpu().numpy()), ref_grid)
        and np.array_equal(state.agent_pos[0].cpu().numpy(), np.asarray(ref_env.agent_pos))
        and int(state.agent_dir[0]) == int(ref_env.agent_dir)
        and np.array_equal(state.carrying[0].cpu().numpy(), encode_obj(ref_env.carrying))
    )


# -- network parameters: the flax trees of minigrid_tpu/rl ------------------------------
#
# A tree is the nested dict of numpy arrays that
# ``jax.tree_util.tree_map(np.asarray, variables)`` gives (``{"params": ...}``).
# Dense kernels are ``[in, out]`` in flax and ``weight [out, in]`` here; conv
# kernels HWIO there and OIHW here; embedding tables are the same.  The LSTM
# cell's four input kernels (ii, if, ig, io; no bias) and four hidden kernels
# (hi, hf, hg, ho, with the biases) stack, transposed, into ``weight_ih``,
# ``weight_hh`` and ``bias_hh``.  Every value is copied bit for bit.

_EMBEDS = ("type_embed", "color_embed", "state_embed", "dir_embed", "mission_embed")
_GATES = "ifgo"


def _dense_to_flax(sd: dict, prefix: str) -> dict:
    return {"kernel": sd[prefix + "weight"].T, "bias": sd[prefix + "bias"]}


def _encoder_to_flax(sd: dict) -> dict:
    out = {f"Embed_{i}": {"embedding": sd[f"encoder.{name}.weight"]}
           for i, name in enumerate(_EMBEDS)}
    i = 0
    while f"encoder.convs.{i}.weight" in sd:
        out[f"Conv_{i}"] = {"kernel": sd[f"encoder.convs.{i}.weight"].transpose(2, 3, 1, 0),
                            "bias": sd[f"encoder.convs.{i}.bias"]}
        i += 1
    out["Dense_0"] = _dense_to_flax(sd, "encoder.dense.")
    return out


def _numpy_state(params) -> dict:
    """A module's parameters, or a dict of tensors keyed by parameter name
    (gradients, say), as float32 numpy keyed by name."""
    named = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return {k: v.detach().cpu().numpy() for k, v in named}


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree)


def actor_critic_to_flax(params) -> dict:
    """An ``ActorCritic``'s parameters (the module, or a dict of tensors
    keyed by its parameter names, such as their gradients) -> the flax
    ``{"params": ...}`` tree of ``minigrid_tpu.rl.ActorCritic``."""
    sd = _numpy_state(params)
    return _contiguous({"params": {
        "ObsEncoder_0": _encoder_to_flax(sd),
        "Dense_0": _dense_to_flax(sd, "dense."),
        "Dense_1": _dense_to_flax(sd, "policy."),
        "Dense_2": _dense_to_flax(sd, "value."),
    }})


def recurrent_to_flax(params) -> dict:
    """A ``RecurrentActorCritic``'s parameters (module or dict of tensors)
    -> the flax tree of ``minigrid_tpu.rl.RecurrentActorCritic``."""
    sd = _numpy_state(params)
    h = sd["cell.weight_hh"].shape[1]
    cell = {}
    for g, gate in enumerate(_GATES):
        rows = slice(g * h, (g + 1) * h)
        cell["i" + gate] = {"kernel": sd["cell.weight_ih"][rows].T}
        cell["h" + gate] = {"kernel": sd["cell.weight_hh"][rows].T,
                            "bias": sd["cell.bias_hh"][rows]}
    return _contiguous({"params": {
        "ObsEncoder_0": _encoder_to_flax(sd),
        "OptimizedLSTMCell_0": cell,
        "Dense_0": _dense_to_flax(sd, "policy."),
        "Dense_1": _dense_to_flax(sd, "value."),
    }})


def _dense_from_flax(leaf: dict, prefix: str) -> dict:
    return {prefix + "weight": leaf["kernel"].T, prefix + "bias": leaf["bias"]}


def _encoder_from_flax(enc: dict) -> tuple[dict, dict]:
    """(state dict entries, encoder sizes) of a flax ``ObsEncoder_0``."""
    sd = {f"encoder.{name}.weight": enc[f"Embed_{i}"]["embedding"]
          for i, name in enumerate(_EMBEDS)}
    convs = []
    while f"Conv_{len(convs)}" in enc:
        i = len(convs)
        kernel = enc[f"Conv_{i}"]["kernel"]
        sd[f"encoder.convs.{i}.weight"] = kernel.transpose(3, 2, 0, 1)
        sd[f"encoder.convs.{i}.bias"] = enc[f"Conv_{i}"]["bias"]
        convs.append(kernel.shape[3])
    sd.update(_dense_from_flax(enc["Dense_0"], "encoder.dense."))
    embed_dim = enc["Embed_0"]["embedding"].shape[1]
    rows, hidden = enc["Dense_0"]["kernel"].shape
    view = int(round(((rows - 2 * embed_dim) / convs[-1]) ** 0.5))
    if view * view * convs[-1] + 2 * embed_dim != rows:
        raise ValueError(f"ObsEncoder_0/Dense_0 has {rows} input rows: not a square view")
    return sd, {"embed_dim": embed_dim, "conv_features": tuple(convs), "hidden": hidden,
                "view": view}


def _load(net, sd: dict, view: int, device):
    net.build(view)
    net.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                         for k, v in sd.items()})
    return net.to(resolve_device(device))


def actor_critic_from_flax(tree: dict, dtype: torch.dtype = torch.bfloat16, device=None):
    """The flax tree of ``minigrid_tpu.rl.ActorCritic`` -> a built port
    ``ActorCritic`` computing in ``dtype`` on ``device`` (CUDA unless
    named), its sizes read from the tree."""
    from minigrid_tpu_torch.rl.networks import ActorCritic

    params = tree.get("params", tree)
    sd, sizes = _encoder_from_flax(params["ObsEncoder_0"])
    sd.update(_dense_from_flax(params["Dense_0"], "dense."))
    sd.update(_dense_from_flax(params["Dense_1"], "policy."))
    sd.update(_dense_from_flax(params["Dense_2"], "value."))
    net = ActorCritic(num_actions=params["Dense_1"]["kernel"].shape[1],
                      embed_dim=sizes["embed_dim"], conv_features=sizes["conv_features"],
                      hidden=sizes["hidden"], dtype=dtype)
    return _load(net, sd, sizes["view"], device)


def recurrent_from_flax(tree: dict, dtype: torch.dtype = torch.bfloat16, device=None):
    """The flax tree of ``minigrid_tpu.rl.RecurrentActorCritic`` -> a built
    port ``RecurrentActorCritic`` in ``dtype`` on ``device``."""
    from minigrid_tpu_torch.rl.rnn import RecurrentActorCritic

    params = tree.get("params", tree)
    sd, sizes = _encoder_from_flax(params["ObsEncoder_0"])
    cell = params["OptimizedLSTMCell_0"]
    sd["cell.weight_ih"] = np.concatenate([cell["i" + g]["kernel"].T for g in _GATES])
    sd["cell.weight_hh"] = np.concatenate([cell["h" + g]["kernel"].T for g in _GATES])
    sd["cell.bias_hh"] = np.concatenate([cell["h" + g]["bias"] for g in _GATES])
    sd.update(_dense_from_flax(params["Dense_0"], "policy."))
    sd.update(_dense_from_flax(params["Dense_1"], "value."))
    net = RecurrentActorCritic(num_actions=params["Dense_0"]["kernel"].shape[1],
                               hidden=sizes["hidden"], embed_dim=sizes["embed_dim"],
                               conv_features=sizes["conv_features"], dtype=dtype)
    return _load(net, sd, sizes["view"], device)


def shard_params(params: dict, placement: dict) -> dict:
    """A full parameter set ``{name: tensor}`` -> one rank's: each parameter
    placed by a ``Shard`` (``rl.tp_param_sharding``) cut to its rows along
    its dim, the others whole."""
    out = {}
    for name, value in params.items():
        shard = placement.get(name)
        out[name] = value if shard is None else value.index_select(
            shard.dim, torch.tensor(shard.rows, device=value.device))
    return out


def unshard_params(shards: list[dict], placements: list[dict]) -> dict:
    """Every rank's parameters and placement -> the full set: each sharded
    parameter put together from the ranks' rows, which must cover it, each
    other one rank 0's."""
    out = {}
    for name, first in shards[0].items():
        shard = placements[0].get(name)
        if shard is None:
            out[name] = first
            continue
        full = first.new_empty(shard.shape)
        covered = torch.zeros(shard.shape[shard.dim], dtype=torch.bool)
        for params, placement in zip(shards, placements):
            rows = torch.tensor(placement[name].rows)
            full.index_copy_(shard.dim, rows.to(full.device), params[name])
            covered[rows] = True
        if not bool(covered.all()):
            raise ValueError(f"{name}: the ranks' slices do not cover its dim {shard.dim}")
        out[name] = full
    return out
