"""The mesh's ``model`` axis: tensor parallel over output channels (port of
multiagentperception_tpu/parallel/mesh.py:59-85, ``_spec_for_param`` /
``param_shardings``, and its placement in trainer.py:307-320).

JAX shards every parameter of two or more dims on its last dim (the output
features) over ``model`` where that dim is at least 64 and divides by M;
biases, BatchNorm and everything else replicate, and the batch shards over
``data`` alone. The sharding is a placement: the program, and so its
result, is the one-device program's. In the port the M ranks of a model
group (``Layout.model_group``) hold one replica between them:

- ``shard_rule`` names the dim a port layer's weight shards on: the output
  dim, dim 0 of ``Conv2d`` and ``Linear``, dim 1 of ``ConvTranspose2d``
  (flax's kernels end in the output features; torch's put them first, or
  second for a transposed conv). JAX's test (>= 64, divides M) applies to it.
- ``parallelize`` makes every such layer of a model of any architecture
  its column-parallel class, in place (its class changes, as
  ``sync_bn.attach`` does; its weight becomes the rank's shard, its bias
  stays whole): no ``state_dict`` key changes. Its forward passes the
  input through ``_ToModel`` (the identity, whose backward sums the input's
  gradient over the model group: each rank's shard sees only its share of
  the output's gradient), computes the rank's output channels with the
  bias's slice of them (the bias enters through ``_ToModel`` too, so its
  gradient is whole on every rank), and all-gathers them along the channel
  dim (``_GatherChannels``, whose backward takes the rank's slice). The
  layer's arithmetic per output channel is the one-process layer's.
- ``shard_state_dict`` / ``gather_state_dict`` and
  ``shard_optimizer_state`` / ``gather_optimizer_state`` carry a
  one-process ``state_dict`` (``convert.state_dict_from_flax``, a ``.pkl``)
  to a rank's shards and back; a gathered dict loads with ``strict=True``
  into a one-process model. Adam's moments of a shard live on its rank.

Every rank of a model group sees the same input rows, so everything
outside the sharded layers (BatchNorm, the comm step, K1, K2, the loss) is
computed alike on each of them.
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Linear
from multiagentperception_tpu_torch.parallel.collectives import (
    Group,
    all_gather_cat,
    all_reduce_sum,
)

MIN_FEATURES = 64  # JAX's floor on a sharded dim (mesh.py:82)


class _ToModel(torch.autograd.Function):
    """The identity; backward: the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """Every rank's channels along ``dim``, in rank order; backward: this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, group: Group, dim: int):
        ctx.group, ctx.dim, ctx.local = group, dim, y.shape[dim]
        return all_gather_cat(y, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.group.rank * ctx.local, ctx.local).contiguous(), \
            None, None


def shard_rule(mod: nn.Module, n_model: int) -> int | None:
    """The dim ``mod``'s weight shards on over ``n_model`` ranks, or None
    (replicated): the output dim of a ``Conv2d``, ``Linear`` or
    ``ConvTranspose2d`` where it is >= 64 and divides ``n_model``."""
    if n_model <= 1:
        return None
    if isinstance(mod, ConvTranspose2d):
        dim = 1
    elif isinstance(mod, (Conv2d, Linear)):
        dim = 0
    else:
        return None
    size = mod.weight.shape[dim]
    return dim if size >= MIN_FEATURES and size % n_model == 0 else None


class ColumnParallel:
    """What the column-parallel layers share (module docstring): ``group``
    (the model group), ``shard_dim`` (the weight's output dim),
    ``full_weight_shape`` and ``local_out`` (this rank's output channels)."""

    group: Group
    shard_dim: int
    full_weight_shape: tuple
    local_out: int
    channel_dim = 1  # the output's channel dim

    @property
    def offset(self) -> int:
        return self.group.rank * self.local_out

    def take(self, full: torch.Tensor, dim: int | None = None) -> torch.Tensor:
        """This rank's slice of a whole weight (or of a bias, ``dim=0``)."""
        dim = self.shard_dim if dim is None else dim
        return full.narrow(dim, self.offset, self.local_out)

    def local_bias(self) -> torch.Tensor | None:
        """The bias's slice of this rank's channels (inference: no gradient)."""
        return None if self.bias is None else self.take(self.bias.detach(), 0)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The rank's output channels -> every rank's, along the channel dim."""
        return _GatherChannels.apply(y, self.group, self.channel_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _ToModel.apply(x, self.group)
        bias = None if self.bias is None else self.take(_ToModel.apply(self.bias, self.group), 0)
        return self.gather(self.compute(x, self.weight, bias))


class ColumnConv2d(ColumnParallel, Conv2d):
    pass


class ColumnLinear(ColumnParallel, Linear):
    channel_dim = -1


class ColumnConvTranspose2d(ColumnParallel, ConvTranspose2d):
    pass


_COLUMN = {Conv2d: ColumnConv2d, Linear: ColumnLinear, ConvTranspose2d: ColumnConvTranspose2d}


@torch.no_grad()
def parallelize(model: nn.Module, group: Group) -> int:
    """Make every layer of ``model`` that ``shard_rule`` shards over the
    group's ranks its column-parallel class, holding this rank's shard
    (in place; returns how many)."""
    count = 0
    for mod in model.modules():
        dim = shard_rule(mod, group.size) if type(mod) in _COLUMN else None
        if dim is None:
            continue
        full = mod.weight
        mod.__class__ = _COLUMN[type(mod)]
        mod.group, mod.shard_dim = group, dim
        mod.full_weight_shape = tuple(full.shape)
        mod.local_out = full.shape[dim] // group.size
        mod.weight = nn.Parameter(mod.take(full).clone(), requires_grad=full.requires_grad)
        count += 1
    return count


def sharded(model: nn.Module) -> dict[str, ColumnParallel]:
    """``{weight's state_dict name: its layer}`` of the sharded layers."""
    return {f"{name}.weight": mod for name, mod in model.named_modules()
            if isinstance(mod, ColumnParallel)}


def shard_ids(model: nn.Module) -> set[int]:
    """The ``id`` of every sharded parameter."""
    return {id(mod.weight) for mod in sharded(model).values()}


def shard_state_dict(full: dict, model: nn.Module) -> dict:
    """A one-process ``state_dict`` -> this rank's, for ``model``'s shards."""
    layers = sharded(model)
    return {k: layers[k].take(v).clone() if k in layers else v for k, v in full.items()}


def gather_state_dict(model: nn.Module) -> dict:
    """``model``'s ``state_dict`` with every shard gathered over its model
    group: the one-process ``state_dict``. Every rank of the group calls
    it (a collective a shard)."""
    layers = sharded(model)
    return {k: all_gather_cat(v, layers[k].group, layers[k].shard_dim) if k in layers else v
            for k, v in model.state_dict().items()}


def _indexed_shards(optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """``{index in the optimizer's state_dict: layer}`` of the shards."""
    by_id = {id(mod.weight): mod for mod in sharded(model).values()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: by_id[id(p)] for i, p in enumerate(params) if id(p) in by_id}


def gather_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """The optimizer's ``state_dict`` with every moment of a shard gathered
    (a collective each; every rank of the group calls it)."""
    sd = optimizer.state_dict()
    for i, mod in _indexed_shards(optimizer, model).items():
        st = sd["state"][i] = dict(sd["state"].get(i, {}))  # the live state stays as it is
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.shape == mod.weight.shape:
                st[k] = all_gather_cat(v, mod.group, mod.shard_dim)
    return sd


def shard_optimizer_state(sd: dict, optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """A one-process optimizer ``state_dict`` -> this rank's moments."""
    state = {i: dict(st) for i, st in sd["state"].items()}
    for i, mod in _indexed_shards(optimizer, model).items():
        for k, v in state.get(i, {}).items():
            if isinstance(v, torch.Tensor) and tuple(v.shape) == mod.full_weight_shape:
                state[i][k] = mod.take(v).clone()
    return {**sd, "state": state}
