"""Megatron tensor parallelism over the mesh's ``model`` axis (port of the
``tp_spec`` / ``param_shardings`` rules of vidsitu_tpu/parallel/mesh.py:
101-199).

The split points are those of the JAX package's ``tp_spec``, by module:

  * ``MultiHeadAttention``: ``{q,k,v}_proj`` column-parallel (rows of the
    weight and bias: the rows are head-major, so a rank holds H/n whole
    heads), ``out_proj`` row-parallel (the same columns of the weight; the
    bias added once, after the all-reduce); only where n divides H, else
    the whole module stays replicated;
  * ``FFN``: ``fc1`` column-parallel (bias sliced with it), ``fc2``
    row-parallel (bias after the all-reduce); only where n divides the
    hidden width.

Everything else (LayerNorms, embeddings, output projections, the relative
transformer, whose projections are named ``wq`` / ``linear1``, the RoBERTa
pooler and head, the video backbone, the MLPs) is replicated, as ``tp_spec``
leaves it. The layers stay plain modules holding plain parameters of their
local shape: every projection of the port goes through
``models.common.linear``, which DTensor's forward hooks on ``nn.Linear``
would never see. A split module enters through :func:`copy_to_model`
(identity forward, gradient all-reduced over the model group backward:
the replicated weights upstream get the whole gradient) and leaves through
:func:`reduce_from_model` (partial sums all-reduced forward, identity
backward). Dropout inside the split region draws the whole mask and keeps
this rank's heads or columns (``models.common.dropout``'s ``split``).

:class:`Split` gathers a split tensor whole over the model group
(checkpoints, Adam's moments, the gradients of a ``grad_accum`` cycle) and
slices a whole one back, by parameter name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from .collectives import model_group


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=model_group())
        return grad


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=model_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` forward, its gradient
    summed over the model group backward (each rank's heads or columns
    contribute a part of it)."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: the ranks' partial sums added
    forward (every rank then holds the whole), the gradient passed as it is
    backward."""
    return _ReduceFromModel.apply(x)


def tp_plan(model: nn.Module, n: int) -> Dict[str, int]:
    """The parameters that a model axis of extent ``n`` splits, by name, with
    the dimension each is split along (0: column-parallel weight or bias,
    1: row-parallel weight), for a model that is not split yet."""
    from ..models.transformer import FFN, MultiHeadAttention

    dims: Dict[str, int] = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention) and m.n_heads % n == 0:
            for proj in ("q_proj", "k_proj", "v_proj"):
                dims[f"{pre}{proj}.weight"] = 0
                dims[f"{pre}{proj}.bias"] = 0
            dims[f"{pre}out_proj.weight"] = 1
        elif isinstance(m, FFN) and m.fc1.out_features % n == 0:
            dims.update({f"{pre}fc1.weight": 0, f"{pre}fc1.bias": 0,
                         f"{pre}fc2.weight": 1})
    return dims


@dataclass(frozen=True)
class Split:
    """The split parameters (name -> dimension), this rank's model
    coordinate and the extent of the axis."""

    dims: Dict[str, int]
    coord: int
    n: int

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor of parameter ``name`` (a view;
        the tensor itself when ``name`` is not split)."""
        d = self.dims.get(name)
        if d is None or t.dim() == 0:
            return t
        size = t.shape[d] // self.n
        return t.narrow(d, self.coord * size, size)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from every rank's slice (a
        collective over the model group when ``name`` is split: every rank
        of the group calls it for the same names in the same order)."""
        d = self.dims.get(name)
        if d is None or t.dim() == 0:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t, group=model_group())
        return torch.cat(parts, d)


def shard_tp(model: nn.Module, mesh) -> Optional[Split]:
    """Split ``model``'s attention and FFN modules over ``mesh``'s ``model``
    axis in place (see the module docstring); returns the :class:`Split`,
    also kept as ``model.tp_split``, or None when the mesh has no model axis
    of extent > 1. Each split parameter becomes this rank's slice, a
    contiguous copy (FSDP2 takes no views), with its ``requires_grad``; a
    split attention module computes ``n_heads`` / n heads."""
    from ..models.transformer import FFN, MultiHeadAttention
    from .mesh import model_coord, model_extent

    n = model_extent(mesh)
    if n == 1:
        return None
    split = Split(tp_plan(model, n), model_coord(mesh), n)
    for name, d in split.dims.items():
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        old = getattr(mod, attr)
        new = split.local(name, old.detach()).contiguous().clone()
        setattr(mod, attr, nn.Parameter(new, requires_grad=old.requires_grad))
        if attr == "weight":
            if d == 0:
                mod.out_features = new.shape[0]
            else:
                mod.in_features = new.shape[1]
    tp = (split.coord, n)
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention) and \
                f"{pre}q_proj.weight" in split.dims:
            m.n_heads //= n
            m.tp = tp
        elif isinstance(m, FFN) and f"{pre}fc1.weight" in split.dims:
            m.tp = tp
    model.tp_split = split
    return split


def unshard_tp(model: nn.Module, whole: Dict[str, torch.Tensor]) -> None:
    """Undo :func:`shard_tp` in place: each split parameter becomes its
    whole tensor of ``whole`` (by name), each split module computes all its
    heads again. A resize re-splits the model so on the survivors' mesh."""
    from ..models.transformer import MultiHeadAttention

    split = split_of(model)
    if split is None:
        return
    for name, d in split.dims.items():
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        old = getattr(mod, attr)
        new = whole[name].to(old.device, old.dtype).contiguous().clone()
        setattr(mod, attr, nn.Parameter(new, requires_grad=old.requires_grad))
        if attr == "weight":
            if d == 0:
                mod.out_features = new.shape[0]
            else:
                mod.in_features = new.shape[1]
    for m in model.modules():
        if getattr(m, "tp", None) is not None:
            if isinstance(m, MultiHeadAttention):
                m.n_heads *= split.n
            m.tp = None
    del model.tp_split


def split_of(model: nn.Module) -> Optional[Split]:
    """The :class:`Split` of a model that :func:`shard_tp` split, else None."""
    return getattr(model, "tp_split", None)
