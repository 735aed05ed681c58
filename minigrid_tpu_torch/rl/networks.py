"""Actor-critic network over MiniGrid symbolic observations.

Counterpart of ``minigrid_tpu/rl/networks.py`` (a flax module) as
``torch.nn.Module``s with the same fields, the same layers and the same
arithmetic:

* the (V, V, 3) observation is categorical: (type, color, state) are each
  embedded and summed, then two 3x3 convolutions (``padding="SAME"``), the
  direction and the summed mission-slot embeddings, one dense layer;
* precision as flax computes it: parameters are float32, and each layer
  casts its input and its weights to ``dtype`` where it uses them (the
  embedding tables and their sum, the convolutions, the two hidden dense
  layers); the policy and value heads run in float32 on ``x.float()``.
  The casts are written out: ``torch.autocast`` would leave the embedding
  lookups and the sums in float32;
* the convolution's output is flattened channels last, as flax's NHWC
  reshape flattens it, so the first dense layer's rows are (y, x, channel),
  then the direction, then the mission embedding;
* init as flax's: dense and conv kernels ``lecun_normal`` (a normal
  truncated at two standard deviations, variance 1/fan_in), embeddings a
  normal of std ``1/sqrt(embed_dim)`` (``default_embed_init``), biases zero,
  the policy head ``orthogonal(0.01)`` and the value head
  ``orthogonal(1.0)``.

A Dense, Conv or Embed layer can run column-parallel over a ``tp`` mesh
axis (``shard_``, called by ``rl/mesh.py::shard_model_``): it keeps its slice
of the output features (``tp_dim`` of its weight), all-gathers its output
along the feature dim, and adds its whole bias after the gather.

Like a flax module, a network is built by ``init(key, obs)``: the first dense
layer's width follows the observation's view size.  The parameters are drawn
on the CPU from a ``torch.Generator`` seeded from the threefry key, then moved
to the observation's device, so one key gives one set of parameters on any
device.  ``minigrid_tpu_torch.utils.convert`` carries parameters to and from
the flax trees.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.step import NUM_ACTIONS
from minigrid_tpu_torch.rl.mesh import copy_to_tp, gather_from_tp

NUM_TYPES = max(C.OBJECT_TO_IDX.values()) + 1
NUM_CELL_STATES = 4  # door open/closed/locked + headroom
MISSION_VOCAB = 64  # packed mission codes are small ints (template + slots)

# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal initializers divide by it so that the result has the
# variance they promise
_TRUNC_STD = 0.87962566103423978


# -- initializers (flax's, on a torch.Generator) -----------------------------------

def key_generator(key: torch.Tensor) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from a threefry key ``int64[2]``
    (both uint32 words): one key, one stream of parameters."""
    k0, k1 = (int(w) for w in key.reshape(2).tolist())
    return torch.Generator().manual_seed((k0 << 32) | k1)


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at two standard deviations,
    scaled so that its variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def embed_normal_(w: torch.Tensor, embed_dim: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``default_embed_init``: a normal of variance ``1 / embed_dim``."""
    return nn.init.normal_(w, 0.0, 1.0 / math.sqrt(embed_dim), generator=gen)


def orthogonal_(w: torch.Tensor, gain: float, gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal(gain)`` on a ``[out, in]`` weight: orthonormal rows
    (or columns, whichever are fewer) times ``gain``."""
    return nn.init.orthogonal_(w, gain, generator=gen)


# -- layers with flax's casts ------------------------------------------------------

class _ColumnParallel(nn.Module):
    """A layer whose weight can be cut to one rank's slice of its output
    features (dim ``tp_dim``), its output gathered over the ``tp`` axis."""

    tp_dim = 0
    tp = None  # the tp MeshAxis once sharded

    def shard_(self, tp) -> None:
        k = self.weight.shape[self.tp_dim] // tp.size
        local = self.weight.detach().narrow(self.tp_dim, tp.index * k, k).clone()
        self.weight = nn.Parameter(local)
        self.weight.tp_sharded = True
        self.tp = tp


class Dense(_ColumnParallel):
    """flax ``nn.Dense``: ``x W^T``, then ``+ b``, with ``x``, ``W`` and
    ``b`` cast to ``dtype`` where used; the product is rounded to ``dtype``
    before the bias is added, as flax adds it.  ``weight`` is ``[out, in]``
    (the flax kernel transposed)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.tp is None:
            return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)
        y = F.linear(copy_to_tp(x, self.tp).to(dtype), self.weight.to(dtype))
        return gather_from_tp(y, self.tp, -1) + self.bias.to(dtype)

    def reset_parameters(self, gen: torch.Generator, gain: float | None = None) -> None:
        """``lecun_normal`` kernel, or ``orthogonal(gain)``; zero bias."""
        with torch.no_grad():
            if gain is None:
                lecun_normal_(self.weight, self.weight.shape[1], gen)
            else:
                orthogonal_(self.weight, gain, gen)
            self.bias.zero_()


class Conv(_ColumnParallel):
    """flax ``nn.Conv(features, (3, 3), padding="SAME")`` on NCHW input, the
    bias added after the convolution as in :class:`Dense`: ``weight`` is
    OIHW (the flax HWIO kernel permuted)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.tp is None:
            return (F.conv2d(x.to(dtype), self.weight.to(dtype), padding=1)
                    + self.bias.to(dtype)[:, None, None])
        y = F.conv2d(copy_to_tp(x, self.tp).to(dtype), self.weight.to(dtype), padding=1)
        return gather_from_tp(y, self.tp, 1) + self.bias.to(dtype)[:, None, None]

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, self.weight[0].numel(), gen)
            self.bias.zero_()


class Embed(_ColumnParallel):
    """flax ``nn.Embed``: the table cast to ``dtype``, then the lookup."""

    tp_dim = 1

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = F.embedding(idx, self.weight.to(dtype))
        return out if self.tp is None else gather_from_tp(out, self.tp, -1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            embed_normal_(self.weight, self.weight.shape[1], gen)


# -- the networks --------------------------------------------------------------------

class ObsEncoder(nn.Module):
    """Embeds the symbolic obs dict into a single feature vector
    ``[B, out_features]`` in ``dtype``."""

    def __init__(self, embed_dim: int = 16, conv_features: Sequence[int] = (128, 128),
                 out_features: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embed_dim = embed_dim
        self.conv_features = tuple(conv_features)
        self.out_features = out_features
        self.dtype = dtype

    def build(self, view_size: int) -> "ObsEncoder":
        """Create the layers (uninitialised) for a ``view_size`` observation."""
        e = self.embed_dim
        self.type_embed = Embed(NUM_TYPES, e)
        self.color_embed = Embed(C.NUM_COLORS, e)
        self.state_embed = Embed(NUM_CELL_STATES, e)
        widths = (e,) + self.conv_features
        self.convs = nn.ModuleList(Conv(a, b) for a, b in zip(widths, widths[1:]))
        self.dir_embed = Embed(4, e)
        self.mission_embed = Embed(MISSION_VOCAB, e)
        self.dense = Dense(view_size * view_size * widths[-1] + 2 * e, self.out_features)
        return self

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Every parameter drawn from ``gen`` in the layers' order."""
        for layer in (self.type_embed, self.color_embed, self.state_embed, *self.convs,
                      self.dir_embed, self.mission_embed, self.dense):
            layer.reset_parameters(gen)

    def forward(self, obs: dict) -> torch.Tensor:
        dt = self.dtype
        img = obs["image"].long()  # [B, V, V, 3]
        x = (self.type_embed(img[..., 0], dt) + self.color_embed(img[..., 1], dt)
             + self.state_embed(img[..., 2].clamp(0, NUM_CELL_STATES - 1), dt))
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
        for conv in self.convs:
            x = F.relu(conv(x, dt))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC flatten
        d = self.dir_embed(obs["direction"].long(), dt)
        m = self.mission_embed(obs["mission"].long().clamp(0, MISSION_VOCAB - 1),
                               dt).sum(dim=-2)
        return F.relu(self.dense(torch.cat([x, d, m], dim=-1), dt))


class ActorCritic(nn.Module):
    """Policy + value heads over the shared encoder.

    ``forward(obs)`` returns (logits float32[B, A], value float32[B]); the
    heads run in float32 for a stable softmax and value regression."""

    def __init__(self, num_actions: int = NUM_ACTIONS, embed_dim: int = 16,
                 conv_features: Sequence[int] = (128, 128), hidden: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_actions = num_actions
        self.hidden = hidden
        self.dtype = dtype
        self.encoder = ObsEncoder(embed_dim, conv_features, hidden, dtype)

    def build(self, view_size: int) -> "ActorCritic":
        """Create the layers (uninitialised, on the CPU) for ``view_size``."""
        self.encoder.build(view_size)
        self.dense = Dense(self.hidden, self.hidden)
        self.policy = Dense(self.hidden, self.num_actions)
        self.value = Dense(self.hidden, 1)
        return self

    def init(self, key: torch.Tensor, obs: dict) -> "ActorCritic":
        """Build for ``obs``'s view size and draw every parameter from a
        generator seeded from ``key``, on the CPU; then move to ``obs``'s
        device.  Returns ``self``."""
        self.build(obs["image"].shape[-2])
        gen = key_generator(key)
        self.encoder.reset_parameters(gen)
        self.dense.reset_parameters(gen)
        self.policy.reset_parameters(gen, gain=0.01)
        self.value.reset_parameters(gen, gain=1.0)
        return self.to(obs["image"].device)

    def forward(self, obs: dict) -> tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.dense(self.encoder(obs), self.dtype)).float()
        return self.policy(x, torch.float32), self.value(x, torch.float32).squeeze(-1)
