"""The learner's mesh: data- and tensor-parallel PPO on ``torch.distributed``.

Counterpart of the mesh half of ``minigrid_tpu/rl/ppo.py`` (``PPO(mesh=)``
and ``tp_param_sharding``).  JAX compiles one program for the global batch
and lets GSPMD partition it; here each rank runs the global program's share
of it, and the result is the global program's (up to the order of float
sums):

* ``dp``: a rank steps its rows of the env batch (every key is split from a
  key every rank holds, and each batch-wide draw is drawn over the global
  shape, of which the rank keeps its rows).  The epochs shuffle the global
  T*B transitions with one permutation, as JAX does; a rank computes the
  loss over the transitions it owns in each global minibatch as sums over
  the minibatch's row count (:class:`ShardMean`), so that one all-reduce of
  the gradients, as one flat buffer with the minibatch's metrics, gives the
  gradient of the minibatch mean.  The advantage normaliser's mean and
  standard deviation take one scalar all-reduce each.
* ``tp``: every parameter whose flax leaf has 2 or more dims and a last
  dim divisible by ``tp`` is sharded on it (:func:`tp_param_sharding`, JAX's
  rule); that dim is the output features of a Dense or Conv kernel and the
  features of an embedding table.  Those layers run column-parallel with a
  gathered output (Megatron's pair of autograd functions: the input copied
  into the ``tp`` group, whose gradient is all-reduced; the output
  all-gathered, whose gradient is the rank's slice), the bias replicated and
  added after the gather, as flax adds it to the rounded product.  The
  global gradient norm sums the sharded leaves' squares over ``tp``.  The
  ranks of one ``tp`` group step the same env rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from minigrid_tpu_torch.parallel.sharding import MeshAxis, Shard, mesh_axis


class LearnerMesh(NamedTuple):
    """This rank's place on the learner's ``dp`` and ``tp`` axes (``tp``
    of size 1 when the mesh has none)."""

    dp: MeshAxis
    tp: MeshAxis

    @staticmethod
    def from_mesh(mesh) -> "LearnerMesh":
        names = mesh.mesh_dim_names or ()
        if "dp" not in names:
            raise ValueError(f"mesh must have a 'dp' axis, got {names}")
        tp = mesh_axis(mesh, "tp") if "tp" in names else MeshAxis(0, 1, None)
        return LearnerMesh(mesh_axis(mesh, "dp"), tp)


# -- tensor-parallel layers -------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the input gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along ``dim`` forward; the rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, \
            None, None, None


def copy_to_tp(x: torch.Tensor, tp: MeshAxis) -> torch.Tensor:
    return _CopyToTP.apply(x, tp.group)


def gather_from_tp(x: torch.Tensor, tp: MeshAxis, dim: int) -> torch.Tensor:
    return _GatherFromTP.apply(x, tp.group, tp.size, tp.index, dim % x.dim())


def flax_axes(name: str) -> tuple[int, ...]:
    """The dims of the port's ``ActorCritic`` parameter ``name`` in the order
    of its flax leaf's axes, as ``utils/convert.py`` lays them out: a Dense
    weight ``[out, in]`` is the kernel ``[in, out]`` transposed, a conv
    weight OIHW the HWIO kernel permuted; an embedding table ``[num,
    features]`` and a bias are the same in both."""
    if name.endswith(".bias"):
        return (0,)
    if name.endswith("_embed.weight"):
        return (0, 1)
    if name.startswith("encoder.convs."):
        return (2, 3, 1, 0)
    return (1, 0)


def tp_param_sharding(model: nn.Module, mesh, axis: str = "tp") -> dict:
    """JAX's tensor-parallel rule on the port's ``ActorCritic``: ``{name:
    Shard or None}``, this rank's slice of each parameter sharded over the
    mesh axis ``axis`` and ``None`` for a replicated one.  A parameter is
    sharded where its flax leaf has 2 or more dims and a last dim divisible
    by the axis size (the flax leaf's last dim mapped to the port's through
    :func:`flax_axes`); so the small heads (the ``(H, A)`` policy and
    ``(H, 1)`` value kernels at odd A) and every bias replicate."""
    tp = mesh_axis(mesh, axis)
    out = {}
    for name, p in model.named_parameters():
        axes = flax_axes(name)
        flax_shape = [p.shape[a] for a in axes]
        if len(flax_shape) >= 2 and flax_shape[-1] % tp.size == 0:
            dim = axes[-1]
            k = p.shape[dim] // tp.size
            out[name] = Shard(tuple(p.shape), dim, tuple(range(tp.index * k, (tp.index + 1) * k)))
        else:
            out[name] = None
    return out


def shard_model_(model: nn.Module, placement: dict, tp: MeshAxis) -> None:
    """Cut each sharded parameter of ``placement`` (from
    :func:`tp_param_sharding`) to this rank's slice, in place, and run its
    layer column-parallel over ``tp``."""
    for name, shard in placement.items():
        if shard is None:
            continue
        layer_name, param = name.rsplit(".", 1)
        layer = model.get_submodule(layer_name)
        if param != "weight" or getattr(layer, "tp_dim", None) != shard.dim:
            raise ValueError(f"{name}: no column-parallel layer shards dim {shard.dim}")
        layer.shard_(tp)


# -- the data-parallel loss and gradient --------------------------------------------------

class ShardMean:
    """Means over a minibatch whose rows lie on the ranks of ``dp``: a mean
    here is this rank's share, its rows' sum over the minibatch's ``count``,
    so that summing the shares over the ranks (the gradient all-reduce) gives
    the minibatch's mean.  ``weight`` (0 or 1 a row) masks rows that only pad
    a rank that owns none."""

    def __init__(self, dp: MeshAxis, count: int, weight: torch.Tensor | None = None):
        self.dp, self.count, self.weight = dp, count, weight

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is not None:
            x = x * self.weight
        return x.sum() / self.count

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp.group is not None:
            dist.all_reduce(x, group=self.dp.group)
        return x

    @torch.no_grad()
    def normalize(self, adv: torch.Tensor) -> torch.Tensor:
        """``(adv - mean) / (std + 1e-8)`` with the minibatch's mean and
        population standard deviation, two passes as ``jnp.std`` takes them:
        one scalar all-reduce for each."""
        mean = self._all_reduce(self.mean(adv))
        var = self._all_reduce(self.mean(torch.square(adv - mean)))
        return (adv - mean) / (torch.sqrt(var) + 1e-8)


def reduce_gradients(params: list, extra: dict, dp: MeshAxis) -> dict:
    """Sum every parameter's gradient (a missing one as zeros) and the
    scalars of ``extra`` over ``dp``, as ONE flat buffer: a single
    collective.  The gradients become views of the reduced buffer; returns
    the reduced ``extra``."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    names = list(extra)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([extra[k].float() for k in names])])
    if dp.group is not None:
        dist.all_reduce(flat, group=dp.group)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    return dict(zip(names, flat[offset:].unbind()))


def global_grad_norm(params: list, tp: MeshAxis) -> torch.Tensor | None:
    """The gradients' global norm over the ``tp`` shards: the squares of
    the sharded parameters summed over ``tp`` (one scalar all-reduce), each
    replicated one counted once.  ``None`` without ``tp`` (every gradient is
    whole here)."""
    if tp.size == 1:
        return None
    zero = torch.zeros((), device=params[0].device)
    sharded = sum((torch.sum(torch.square(p.grad)) for p in params
                   if getattr(p, "tp_sharded", False)), zero)
    dist.all_reduce(sharded, group=tp.group)
    whole = sum((torch.sum(torch.square(p.grad)) for p in params
                 if not getattr(p, "tp_sharded", False)), zero)
    return torch.sqrt(sharded + whole)
