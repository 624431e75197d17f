"""Shared model building blocks (port of vidsitu_tpu/models/common.py),
plus what the flax modules get from flax itself: dropout drawn from an
explicit generator (flax's ``rngs={"dropout": key}``) and flax's initial
values (:func:`init_like_flax`)."""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

NEG_INF = -1e9  # additive mask value (finite: avoids NaNs in fully-masked rows)


class MLP(nn.Module):
    """Linear -> ReLU -> Linear stack, as used throughout the reference for
    projection heads (e.g. mdl_sf_base.py:161-167,767-769). Layers are
    named ``layers_{i}`` like the flax module's Dense children. ``dtype``
    is the compute dtype (flax ``dtype``): inputs and weights are cast to
    it, parameters stay in their own dtype."""

    def __init__(self, din: int, features: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [din, *features]
        self.n_layers = len(features)
        self.dtype = dtype
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            lin = self._modules[f"layers_{i}"]
            x = lin(x) if self.dtype is None else linear(lin, x, self.dtype)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


_DROPOUT = threading.local()


@contextlib.contextmanager
def dropout_generator(gen: Optional[torch.Generator], rank: int = 0,
                      world: int = 1, examples: Optional[int] = None):
    """Draw every dropout mask inside the block from ``gen`` (a
    ``torch.Generator`` on the device of the activations), as flax's
    ``apply(..., rngs={"dropout": key})`` does for one step. Blocks nest;
    the innermost generator is used.

    With ``world`` > 1 the block runs rank ``rank``'s share of a global
    batch: its ``examples`` examples are the global batch's rows
    ``rank::world`` (the loader's ``ShardedSampler`` layout). Every rank
    holds the same generator, draws the mask of the global batch and keeps
    its own examples' rows, so the masks do not depend on the number of
    ranks (the JAX package draws them for the global batch in one
    program). That costs ``world`` times the random draws of a step."""
    prev = (getattr(_DROPOUT, "gen", None), getattr(_DROPOUT, "shard", None))
    _DROPOUT.gen = gen
    _DROPOUT.shard = (rank, world, examples) if world > 1 else None
    try:
        yield gen
    finally:
        _DROPOUT.gen, _DROPOUT.shard = prev


@contextlib.contextmanager
def deterministic():
    """No dropout inside the block, whatever the modules' mode (the JAX
    package's ``deterministic=True`` of its decode entry points)."""
    prev = getattr(_DROPOUT, "off", False)
    _DROPOUT.off = True
    try:
        yield
    finally:
        _DROPOUT.off = prev


def dropout(x: torch.Tensor, rate: float, training: bool,
            split: Optional[tuple] = None) -> torch.Tensor:
    """The JAX package's ``_dropout`` (models/transformer.py:254): identity
    when ``rate`` is 0, the module is in ``eval()`` or inside
    :func:`deterministic`, else ``x * keep / (1 - rate)`` with ``keep``
    drawn from the generator of the innermost :func:`dropout_generator`
    block. Never the global random state: a training forward outside such a
    block raises.

    Under a block of several ranks, ``x``'s leading dimension must be
    example-major: the block's examples, each with the same number of rows
    (events, pairs, annotations folded in). Every site of the models is:
    (B, T, D) activations, (B, H, T, S) attention probabilities, and (B*5,
    ...) or (B*4*N, ...) where events or pairs are folded in behind the
    example. A leading dimension that is not a multiple of the examples
    raises.

    ``split`` = (dim, coord, n): ``x`` is part ``coord`` of ``n`` equal parts
    along ``dim`` of the whole activation (tensor parallelism: this rank's
    heads of the attention probabilities, its hidden columns of the FFN).
    The whole activation's mask is drawn and this part of it kept, so that a
    part's mask is the whole one's and the generator moves alike on every
    rank of the model group."""
    if rate <= 0.0 or not training or getattr(_DROPOUT, "off", False):
        return x
    gen = getattr(_DROPOUT, "gen", None)
    if gen is None:
        raise RuntimeError(
            "dropout in training mode draws from an explicit generator: run "
            "the forward inside models.common.dropout_generator(gen)")
    shape = list(x.shape)
    if split is not None:
        dim, coord, parts = split
        dim %= x.dim()
        shape[dim] *= parts
    shard = getattr(_DROPOUT, "shard", None)
    if shard is None:
        u = torch.rand(shape, generator=gen, device=x.device)
    else:
        rank, world, n = shard
        if not n or x.dim() == 0 or x.shape[0] % n:
            raise RuntimeError(
                f"dropout over {world} ranks: a site's leading dimension "
                f"({tuple(x.shape)}) is not example-major over this rank's "
                f"{n} examples")
        # the global batch's mask, (examples * world, rows of an example);
        # this rank's examples are its rows rank::world
        u = torch.rand((n * world, math.prod(shape) // n), generator=gen,
                       device=x.device)[rank::world].reshape(shape)
    if split is not None:
        u = u.narrow(dim, coord * x.shape[dim], x.shape[dim])
    return x * (u < 1.0 - rate) / (1.0 - rate)


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
           with_bias: bool = True) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to the compute
    dtype, whatever the parameters' own (``param_dtype``), then the
    product. ``with_bias=False`` leaves the bias to the
    caller (a row-parallel product adds it after its all-reduce)."""
    bias = None if lin.bias is None or not with_bias else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


@torch.no_grad()
def cast_params(model: nn.Module, param_dtype: torch.dtype) -> nn.Module:
    """flax's ``param_dtype`` on a built model: every floating parameter in
    ``param_dtype``; the buffers (BatchNorm running statistics, position
    tables) keep their own dtype, as flax keeps ``batch_stats`` in float32.
    The parameters stay the same objects. The products still run in each
    module's compute dtype (``dtype``): :func:`linear`, the convolutions
    and the embeddings cast a parameter to it at use, the normalisations
    promote it to float32, as flax's ``promote_dtype`` does. Returns
    ``model``."""
    for p in model.parameters():
        if p.is_floating_point() and p.dtype != param_dtype:
            p.data = p.data.to(param_dtype)
    return model


@torch.no_grad()
def take_dtypes(model: nn.Module, state) -> nn.Module:
    """Give each parameter of ``model`` the dtype of its tensor in
    ``state``, a state dict about to be loaded: flax applies
    ``param_dtype`` when it initialises, and variables loaded into the JAX
    package (a restored checkpoint, pretrained weights, given weights) keep
    their arrays' dtype, so a float32 file loaded into a bfloat16 model
    stays float32 there. An fsdp-sharded parameter cannot change dtype in
    place: it raises. Returns ``model``."""
    from torch.distributed.tensor import DTensor

    for name, p in model.named_parameters():
        v = state.get(name)
        if v is None or v.dtype == p.dtype or not v.is_floating_point():
            continue
        if isinstance(p, DTensor):
            raise NotImplementedError(
                f"loading {name} saved in {v.dtype} into an fsdp-sharded "
                f"{p.dtype} model")
        p.data = p.data.to(v.dtype)
    return model


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """Fairseq-style sinusoidal embedding table (sin half | cos half),
    computed in float64 and returned as float32 (as the JAX package)."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(max_len, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((max_len, 1))], axis=1)
    return table.astype(np.float32)


def make_causal_mask(t: int, device=None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(1, 1, T, T) additive causal mask."""
    keep = torch.ones(t, t, dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, NEG_INF).to(dtype)[None, None]


def make_padding_mask(pad_mask: Optional[torch.Tensor],
                      dtype: torch.dtype = torch.float32
                      ) -> Optional[torch.Tensor]:
    """(B, S) {1 keep, 0 pad} -> (B, 1, 1, S) additive mask."""
    if pad_mask is None:
        return None
    return torch.where(pad_mask[:, None, None, :] > 0, 0.0, NEG_INF).to(dtype)


def embedding(n: int, d: int, init_std: Optional[float] = None) -> nn.Embedding:
    """``nn.Embedding`` tagged with its flax ``embedding_init`` for
    :func:`init_like_flax`: a plain normal of ``init_std``, or flax's
    default (variance scaling over D) when None."""
    emb = nn.Embedding(n, d)
    emb.init_std = init_std
    return emb


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax's ``variance_scaling(..., 'normal')``: a normal of ``std`` /
    0.8796 cut at two of its standard deviations."""
    std = std / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_like_flax(model: nn.Module, seed: int) -> nn.Module:
    """flax's default initial values, drawn from ``seed`` (torch's generator,
    so the values differ from the JAX package's; the distributions match):
    conv and dense kernels ``lecun_normal`` (a normal of std sqrt(1 /
    fan_in) / 0.8796, cut at two of its standard deviations), or orthogonal
    where a ``Linear`` is tagged ``flax_init = "orthogonal"`` (an LSTM's
    recurrent kernels); biases zero; embeddings by their ``init_std`` tag
    (see :func:`embedding`); LayerNorm scale one and bias zero; BatchNorm
    scale one (zero where flax's ``scale_init`` is zeros: the final BN of
    each bottleneck under ``zero_init_final_bn``, and the non-local BN),
    shift zero, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            if getattr(m, "flax_init", None) == "orthogonal":
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.orthogonal_(w, generator=gen)
            else:
                w = _trunc_normal(m.weight.shape,
                                  math.sqrt(1.0 / math.prod(m.weight.shape[1:])),
                                  gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = getattr(m, "init_std", None)
            if std is None:
                w = _trunc_normal(m.weight.shape,
                                  math.sqrt(1.0 / m.weight.shape[1]), gen)
            else:
                w = torch.randn(m.weight.shape, generator=gen) * std
            m.weight.copy_(w)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm3d):
            m.weight.fill_(0.0 if getattr(m, "zero_init", False) else 1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return model
