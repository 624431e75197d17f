"""Relative-position-bias transformer encoder (port of
vidsitu_tpu/models/rel_transformer.py; reference: the local transformer
library, utils/transformer_code.py:127-313).

Library surface: no model of the zoo builds it. The JAX package's
semantics:

  * post-LN residual blocks, ``LayerNorm(x + dropout(sublayer(x)))``;
  * attention scores scaled by sqrt(d_model), the FULL model width, not
    the head width;
  * the per-head bias ``pe`` (B, N, N, H) added to the raw dot products
    BEFORE that scaling;
  * a causal mask that subtracts INF above the diagonal;
  * heads formed by chunking the model width;
  * ``mask`` multiplied in before the stack and after every layer; all
    layer outputs returned with ``all_outputs=True``.

Dropout (attention weights, sub-block outputs) is active in ``train()``
only and draws from the generator of ``common.dropout_generator``. Module
names follow the flax tree (``layer_{i}.selfattn.wq``, ``ln_attn``,
``feedforward.linear1``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from . import common
from .common import linear

INF = 1e10


class RelMultiHead(nn.Module):
    """Multi-head attention with an additive per-head relative bias."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1,
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.heads = d_model, n_heads
        self.dropout, self.causal, self.dtype = dropout, causal, dtype
        for name in ("wq", "wk", "wv", "wo"):
            self.add_module(name, nn.Linear(d_model, d_model, bias=False))

    def forward(self, query, key, value, pe=None):
        d, h = self.d_model, self.heads
        b, n, _ = query.shape
        nk = key.shape[1]

        def heads(name, x, length):  # (B, L, D) -> (B, H, L, Dh)
            y = linear(self._modules[name], x, self.dtype)
            return y.view(b, length, h, d // h).transpose(1, 2)

        qh, kh, vh = heads("wq", query, n), heads("wk", key, nk), heads(
            "wv", value, nk)
        dots = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        if self.causal:
            tri = torch.ones(n, nk, device=dots.device).triu(1) * INF
            dots = dots - tri[None, None]
        if pe is not None:
            dots = dots + pe.permute(0, 3, 1, 2).float()
        attn = torch.softmax(dots / math.sqrt(d), dim=-1)
        attn = common.dropout(attn, self.dropout, self.training)
        out = torch.matmul(attn.to(self.dtype), vh)
        out = out.transpose(1, 2).reshape(b, n, d)
        return linear(self._modules["wo"], out, self.dtype)


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, d_hidden: int, dtype: torch.dtype):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_hidden)
        self.linear2 = nn.Linear(d_hidden, d_model)
        self.dtype = dtype

    def forward(self, x):
        return linear(self.linear2, F.relu(linear(self.linear1, x, self.dtype)),
                      self.dtype)


class RelEncoderLayer(nn.Module):
    """Post-LN residual: LayerNorm(x + dropout(sublayer(x)))."""

    def __init__(self, d_model: int, d_hidden: int, n_heads: int,
                 dropout: float = 0.1, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.selfattn = RelMultiHead(d_model, n_heads, dropout, causal, dtype)
        self.ln_attn = nn.LayerNorm(d_model, eps=1e-5)
        self.feedforward = _FeedForward(d_model, d_hidden, dtype)
        self.ln_ff = nn.LayerNorm(d_model, eps=1e-5)

    def _ln(self, ln, x):
        x = x.float()
        return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                            ln.bias.to(x.dtype), ln.eps).to(self.dtype)

    def forward(self, x, pe=None, kv=None):
        """``kv``: optional (key, value) pair for cross-attention (the
        reference's dict-input branch, transformer_code.py:208-214)."""
        key, value = (x, x) if kv is None else kv
        attn = self.selfattn(x, key, value, pe=pe)
        x = self._ln(self.ln_attn,
                     x + common.dropout(attn, self.dropout, self.training))
        ff = self.feedforward(x)
        return self._ln(self.ln_ff,
                        x + common.dropout(ff, self.dropout, self.training))


class RelTransformer(nn.Module):
    """Stack of RelEncoderLayers, named ``layer_{i}``; the last layer's
    output, or all of them with ``all_outputs=True``."""

    def __init__(self, d_model: int, d_hidden: int = 2048, n_layers: int = 6,
                 n_heads: int = 8, dropout: float = 0.1, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", RelEncoderLayer(
                d_model, d_hidden, n_heads, dropout, causal, dtype))

    def forward(self, x: torch.Tensor, x_pe: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                all_outputs: bool = False):
        if mask is not None:
            x = x * mask
        outs: List[torch.Tensor] = []
        for i in range(self.n_layers):
            x = self._modules[f"layer_{i}"](x, pe=x_pe)
            if mask is not None:
                x = x * mask
            outs.append(x)
        return outs if all_outputs else outs[-1]
