"""Shared model building blocks (port of vidsitu_tpu/models/common.py)."""

from __future__ import annotations

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


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to the compute
    dtype, then the product."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


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
