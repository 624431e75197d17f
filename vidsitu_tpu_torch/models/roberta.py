"""RoBERTa encoder (port of vidsitu_tpu/models/roberta.py; replaces HF
``RobertaModel`` / ``RobertaForSequenceClassification`` of the evrel task,
reference: vidsitu_code/mdl_evrel.py:9,21-24,62-64).

The architecture of the published ``roberta-base``: token, pad-offset
learned position and token-type embeddings, their LayerNorm and dropout, a
post-norm encoder stack (``transformer.EncoderLayer`` with erf gelu), a tanh
pooler over the ``<s>`` token, and the classification head with its two
dropouts. Module names follow the flax tree (``word_embeddings``,
``emb_ln``, ``layers_{i}``, ``pooler_dense``; the head's ``dense`` and
``out_proj``), so converted weights (``convert.hf_torch.convert_roberta``)
load through ``convert.from_flax.flax_to_state_dict``. Products run in
``RobertaCfg.dtype``, parameters stay float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from . import common
from .common import embedding, linear, make_padding_mask
from .transformer import EncoderLayer, LayerNorm, TxConfig


@dataclass(frozen=True)
class RobertaCfg:
    vocab_size: int
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_pos: int = 514
    pad_id: int = 1
    dropout: float = 0.1
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    def tx_config(self) -> TxConfig:
        """The encoder layers' config: post-norm, erf gelu, ``dropout`` on
        the attention probabilities and the sub-block outputs, none on the
        FFN activation (roberta.py:37-54)."""
        return TxConfig(
            ln_eps=self.ln_eps, vocab_size=self.vocab_size,
            d_model=self.d_model, ffn_dim=self.ffn_dim,
            n_layers=self.n_layers, n_heads=self.n_heads,
            dropout=self.dropout, attn_dropout=self.dropout, act_dropout=0.0,
            max_len=self.max_pos, normalize_before=False,
            activation="gelu_exact", pad_id=self.pad_id, dtype=self.dtype)


def position_ids_from_tokens(input_ids: torch.Tensor, pad_id: int
                             ) -> torch.Tensor:
    """HF RoBERTa convention: positions count the non-pad tokens, offset by
    pad_id + 1; pads sit at pad_id (create_position_ids_from_input_ids)."""
    mask = (input_ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


class RobertaModel(nn.Module):
    def __init__(self, c: RobertaCfg, add_pooling_layer: bool = True):
        super().__init__()
        self.cfg = c
        self.add_pooling_layer = add_pooling_layer
        self.word_embeddings = embedding(c.vocab_size, c.d_model, 0.02)
        self.position_embeddings = embedding(c.max_pos, c.d_model, 0.02)
        self.token_type_embeddings = embedding(1, c.d_model, 0.02)
        self.emb_ln = LayerNorm(c.d_model, c.ln_eps, c.dtype)
        tx = c.tx_config()
        self.n_layers = c.n_layers
        for i in range(c.n_layers):
            self.add_module(f"layers_{i}", EncoderLayer(tx))
        if add_pooling_layer:
            self.pooler_dense = nn.Linear(c.d_model, c.d_model)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        c = self.cfg
        if attention_mask is None:
            attention_mask = (input_ids != c.pad_id).long()
        pos_ids = position_ids_from_tokens(input_ids, c.pad_id)
        x = (self.word_embeddings(input_ids).to(c.dtype)
             + self.position_embeddings(pos_ids).to(c.dtype)
             + self.token_type_embeddings(torch.zeros_like(input_ids)
                                          ).to(c.dtype))
        x = self.emb_ln(x)
        # HF RobertaEmbeddings drops out after the LayerNorm
        x = common.dropout(x, c.dropout, self.training)
        mask = make_padding_mask(attention_mask)
        for i in range(self.n_layers):
            x = self._modules[f"layers_{i}"](x, mask)
        out = {"last_hidden_state": x}
        if self.add_pooling_layer:
            out["pooler_output"] = torch.tanh(
                linear(self.pooler_dense, x[:, 0], c.dtype))
        return out


class RobertaClassificationHead(nn.Module):
    """dropout -> dense -> tanh -> dropout -> out_proj over the ``<s>``
    token, HF's RobertaClassificationHead (both dropouts)."""

    def __init__(self, d_model: int, num_labels: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dense = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, num_labels)
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        x = common.dropout(hidden[:, 0], self.dropout, self.training)
        x = torch.tanh(linear(self.dense, x, self.dtype))
        x = common.dropout(x, self.dropout, self.training)
        return linear(self.out_proj, x, self.dtype)
