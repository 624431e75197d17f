"""Shared model building blocks (port of vidsitu_tpu/models/common.py)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    """Linear -> ReLU -> Linear stack, as used throughout the reference for
    projection heads (e.g. mdl_sf_base.py:161-167,767-769). Layers are
    named ``layers_{i}`` like the flax module's Dense children."""

    def __init__(self, din: int, features: Sequence[int]):
        super().__init__()
        dims = [din, *features]
        self.n_layers = len(features)
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = self._modules[f"layers_{i}"](x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x
