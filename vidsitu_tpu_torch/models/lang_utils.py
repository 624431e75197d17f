"""LSTM sequence encoder (port of vidsitu_tpu/models/lang_utils.py;
reference: utils/lang_utils.py:9-150).

Library surface kept for capability parity: no model of the zoo builds it.
The JAX package's semantics, which are those of the reference's packed
sequences:

  * left-padded rows (the fairseq convention) are shifted left by their
    leading-pad count, so every row is right-padded (a no-op on rows that
    already are);
  * the backward direction reverses each row WITHIN its valid length, so
    its states at valid positions never see a pad;
  * layer l > 0 of a bidirectional stack reads the concat of both
    directions of layer l - 1, as ``nn.LSTM(bidirectional=True)``;
  * ``final`` is the forward state at the last valid step beside the
    backward state at position 0, taken from the states BEFORE the output
    dropout (the reference returns h_n undropped);
  * dropout ``dropout_in`` on the embeddings, ``dropout_out`` between
    stacked layers and on the outputs, in ``train()`` only, drawn from the
    generator of ``common.dropout_generator``.

Each direction of each layer is one cell named as flax's
``OptimizedLSTMCell`` (``fwd_l{i}`` / ``bwd_l{i}`` with input kernels
``ii``, ``if``, ``ig``, ``io`` and recurrent kernels with bias ``hi``,
``hf``, ``hg``, ``ho``), so flax weights load through
``convert.from_flax.flax_to_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from . import common
from .common import embedding

GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: i, f, o sigmoid gates and a tanh
    candidate g from ``i*(x) + h*(h)``; c' = f c + i g, h' = o tanh(c')."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module("i" + g, nn.Linear(d_in, hidden, bias=False))
            rec = nn.Linear(hidden, hidden)
            rec.flax_init = "orthogonal"  # flax's recurrent_kernel_init
            self.add_module("h" + g, rec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, D) -> hidden states (B, T, H), from zero carries."""
        b, t, _ = x.shape
        w_in = torch.cat([self._modules["i" + g].weight for g in GATES])
        w_h = torch.cat([self._modules["h" + g].weight for g in GATES])
        b_h = torch.cat([self._modules["h" + g].bias for g in GATES])
        xs = torch.matmul(x, w_in.to(x.dtype).t())  # (B, T, 4H)
        h = x.new_zeros(b, self.hidden)
        c = x.new_zeros(b, self.hidden)
        out = []
        for step in range(t):
            z = xs[:, step] + torch.addmm(b_h.to(x.dtype), h,
                                          w_h.to(x.dtype).t())
            zi, zf, zg, zo = z.chunk(4, dim=-1)
            c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h = torch.sigmoid(zo) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class LSTMEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 hidden_dim: int = 256, num_layers: int = 1,
                 bidirectional: bool = False, pad_id: int = 0,
                 dropout_in: float = 0.1, dropout_out: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.pad_id = pad_id
        self.dropout_in = dropout_in
        self.dropout_out = dropout_out
        self.dtype = dtype
        self.embed = embedding(vocab_size, embed_dim)
        d_in = embed_dim
        for li in range(num_layers):
            self.add_module(f"fwd_l{li}", LSTMCell(d_in, hidden_dim))
            if bidirectional:
                self.add_module(f"bwd_l{li}", LSTMCell(d_in, hidden_dim))
            d_in = hidden_dim * (2 if bidirectional else 1)

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """tokens (B, T) -> {'outputs': (B, T, D), 'final': (B, D)}, D the
        hidden width times the directions; outputs are zero at pads."""
        b, t = tokens.shape
        if lengths is None:
            lengths = (tokens != self.pad_id).sum(dim=1)
        ar = torch.arange(t, device=tokens.device)[None, :]
        # left- -> right-padding (fairseq's convert_padding_direction)
        nonpad = tokens != self.pad_id
        lead = torch.where(nonpad.any(dim=1), nonpad.int().argmax(dim=1), 0)
        src = ar + lead[:, None]
        tokens = torch.where(src < t, tokens.gather(1, src.clamp(max=t - 1)),
                             self.pad_id)
        x = self.embed(tokens).to(self.dtype)
        x = common.dropout(x, self.dropout_in, self.training)
        valid = ar < lengths[:, None]
        mask = valid.to(x.dtype)
        # per-row reversal within the valid length (an involution)
        rev_idx = torch.where(valid, (lengths[:, None] - 1 - ar).clamp(0, t - 1),
                              ar)

        def rev(z):
            return z.gather(1, rev_idx[:, :, None].expand_as(z))

        h = x
        for li in range(self.num_layers):
            f = self._modules[f"fwd_l{li}"](h)
            if self.bidirectional:
                bk = self._modules[f"bwd_l{li}"](rev(h))
                h = torch.cat([f, rev(bk)], dim=-1)
            else:
                h = f
            if li < self.num_layers - 1:
                h = common.dropout(h, self.dropout_out, self.training)
        h_final = h * mask[..., None]
        outputs = common.dropout(h, self.dropout_out,
                                 self.training) * mask[..., None]
        idx = (lengths - 1).clamp(0, t - 1)
        last_valid = h_final.gather(
            1, idx[:, None, None].expand(b, 1, h.shape[-1]))[:, 0]
        if self.bidirectional:
            final = torch.cat([last_valid[:, :self.hidden_dim],
                               h_final[:, 0, self.hidden_dim:]], dim=-1)
        else:
            final = last_valid
        return {"outputs": outputs, "final": final}
