"""Transformer encoder/decoder with an explicit KV cache (port of
vidsitu_tpu/models/transformer.py).

Modules carry the flax module names (``layers_0.self_attn.q_proj``), so
``convert.from_flax.flax_to_state_dict`` maps the JAX package's variables
onto ``state_dict()``. Parameters keep their own dtype
(``train.param_dtype``, ``common.cast_params``); every product runs in
``TxConfig.dtype`` (bfloat16 on the GPU), softmax and LayerNorm statistics
in float32, as flax's ``dtype``/``param_dtype`` do.

Attention stays plain matmuls, as the JAX package computes it outside any
Pallas kernel, with its numerics (``transformer.py:132-141``): q divided by
sqrt(Dh) in the compute dtype, the additive mask added to the logits,
softmax in float32, the probabilities cast back.

Dropout sits where the JAX package's ``_dropout`` does, at the same rates:
the attention probabilities (``attn_dropout``), the FFN activation
(``act_dropout``), each sub-block's output before its residual add and the
embeddings (``dropout``). It is active in ``train()`` only and draws its
masks from the generator of ``common.dropout_generator``; ``decode_step``
is deterministic in either mode and draws nothing.

The decode cache is head-major, ``(rows, H, L, Dh)``, where the JAX
package's is ``(rows, L, H, Dh)``: attention then reads each row's keys
and values as contiguous (L, Dh) matrices without a transposed copy of the
cache. A beam reorder moves whole rows, so the layout inside a row does not
matter to it. ``decode_step`` writes the step's K/V into the cache in place
(the JAX package's ``dynamic_update_slice``, clamped the same way).

Under tensor parallelism (``parallel/tensor.py:shard_tp``) an attention
module holds ``n_heads`` / n heads and an FFN ffn / n hidden columns: each
enters through ``copy_to_model`` and leaves through ``reduce_from_model``,
the row-parallel bias added after the reduce; ``tp`` = (this rank's model
coordinate, n), None when whole. The decode cache then holds this rank's
heads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.tensor import copy_to_model, reduce_from_model
from . import common
from .common import (
    NEG_INF,
    embedding,
    linear,
    make_causal_mask,
    make_padding_mask,
    sinusoidal_positions,
)

Cache = Dict[str, Any]


@dataclass(frozen=True)
class TxConfig:
    vocab_size: int
    d_model: int = 1024
    ffn_dim: int = 2048
    n_layers: int = 3
    n_heads: int = 8
    dropout: float = 0.1
    attn_dropout: float = 0.0
    act_dropout: float = 0.0
    max_len: int = 1024
    normalize_before: bool = False
    scale_embed: bool = True
    learned_pos: bool = False
    share_in_out_embed: bool = False
    pad_id: int = 0
    activation: str = "relu"  # "relu" | "gelu" (gelu: GPT-2 flavor)
    final_ln: bool = False  # LayerNorm before the output projection
    ln_eps: float = 1e-5  # fairseq/GPT-2/RoBERTa all use 1e-5
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_cfg(cls, tx_cfg, vocab_size: int, pad_id: int,
                 side: str = "decoder",
                 dtype: torch.dtype = torch.float32) -> "TxConfig":
        p = side  # 'encoder' | 'decoder'
        return cls(
            vocab_size=vocab_size,
            d_model=tx_cfg[f"{p}_embed_dim"],
            ffn_dim=tx_cfg[f"{p}_ffn_embed_dim"],
            n_layers=tx_cfg[f"{p}_layers"],
            n_heads=tx_cfg[f"{p}_attention_heads"],
            dropout=tx_cfg["dropout"],
            attn_dropout=tx_cfg["attention_dropout"],
            act_dropout=tx_cfg["activation_dropout"],
            max_len=tx_cfg[
                "max_target_positions" if p == "decoder" else "max_source_positions"
            ],
            normalize_before=tx_cfg[f"{p}_normalize_before"],
            scale_embed=not tx_cfg["no_scale_embedding"],
            learned_pos=tx_cfg[f"{p}_learned_pos"],
            share_in_out_embed=tx_cfg.get("share_decoder_input_output_embed", False),
            pad_id=pad_id,
            dtype=dtype,
        )


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(use_fast_variance=False)`` with a compute dtype:
    statistics, scale and bias in float32 (float64 for a float64 input),
    the result cast to ``dtype``."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype):
        super().__init__(d, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(stat), self.normalized_shape,
                            self.weight.to(stat), self.bias.to(stat),
                            self.eps).to(self.out_dtype)


def _scale(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x * value`` with ``value`` rounded to x's dtype first (the JAX
    package's ``jnp.sqrt(n).astype(x.dtype)``)."""
    return x * torch.tensor(value, dtype=torch.float32).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Attention whose q/k/v/out projections are flax ``DenseGeneral``s
    (kernels (D, H, Dh) and (H, Dh, D), see ``convert.from_flax``).

    Full-sequence mode: ``forward(q_in, kv_in, mask)``. Incremental mode:
    ``forward(q_in, kv_in, mask, cache=(k, v), cache_index=i)`` with T == 1
    writes this step's K/V at position ``i`` of the head-major cache."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.tp: Optional[Tuple[int, int]] = None
        self.n_heads = n_heads
        self.dropout = dropout
        self.head_dim = d_model // n_heads
        self.dtype = dtype
        inner = n_heads * self.head_dim
        self.q_proj = nn.Linear(d_model, inner)
        self.k_proj = nn.Linear(d_model, inner)
        self.v_proj = nn.Linear(d_model, inner)
        self.out_proj = nn.Linear(inner, d_model)

    def _heads(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, H, T, Dh)."""
        b, t, _ = x.shape
        y = linear(lin, x, self.dtype).view(b, t, self.n_heads, self.head_dim)
        return y.transpose(1, 2)

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else copy_to_model(x)

    def project_kv(self, kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V, (B, H, S, Dh) contiguous (cross-attention caches)."""
        kv = self._enter(kv)
        return (self._heads(self.k_proj, kv).contiguous(),
                self._heads(self.v_proj, kv).contiguous())

    def _query(self, q_in: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.q_proj, self._enter(q_in))
        return q / torch.tensor(math.sqrt(self.head_dim)).to(q.dtype)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """(B, H, T, Dh) -> (B, T, D)."""
        b, h, t, dh = ctx.shape
        flat = ctx.transpose(1, 2).reshape(b, t, h * dh)
        if self.tp is None:
            return linear(self.out_proj, flat, self.dtype)
        out = reduce_from_model(linear(self.out_proj, flat, self.dtype,
                                       with_bias=False))
        return out + self.out_proj.bias.to(self.dtype)

    def _softmax(self, logits: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        if self.tp is None:
            return common.dropout(probs, self.dropout, self.training)
        return common.dropout(probs, self.dropout, self.training,
                              (1, *self.tp))

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q_in (B, T, D); k, v (B, H, S, Dh); mask broadcast to
        (B, H, T, S)."""
        q = self._query(q_in)
        probs = self._softmax(torch.matmul(q, k.transpose(-1, -2)), mask)
        return self._out(torch.matmul(probs, v))

    def attend_ancestry(self, q_in: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, anc: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Beam-slot attention over an UNPERMUTED cache (JAX
        ``attend_ancestry``, transformer.py:147-198).

        ``k``/``v`` are (B*K, H, L, Dh) slot-major: slot (b, j) position t
        holds the K/V of whatever hypothesis occupied beam slot j when step
        t ran. ``anc`` (B, K, L) names the slot holding hypothesis (b, k)'s
        token at position t. The scores of every query against every slot
        are taken in one batched product over (b, j, h); the logits are then
        SELECTED with ``gather`` on the slot axis, and the value weights
        SCATTERED back to it (zero for the slots not chosen), so the cache
        is read once and no gathered copy of K or V is made. Both steps
        move values without arithmetic, as the JAX package's exact 0/1
        contractions do; the value products are summed over slots in
        float32."""
        bsz, beams, length = anc.shape
        h, dh = self.n_heads, self.head_dim
        q = self._query(q_in)  # (B*K, H, 1, Dh)
        qh = q.reshape(bsz, beams, h, dh).transpose(1, 2)  # (B, H, K, Dh)
        qj = qh.unsqueeze(1).expand(bsz, beams, h, beams, dh)  # (B,J,H,K,Dh)
        allp = torch.bmm(qj.reshape(-1, beams, dh),
                         k.reshape(-1, length, dh).transpose(1, 2))
        allp = allp.view(bsz, beams, h, beams, length)  # (B, J, H, K, L)
        idx = anc.view(bsz, 1, 1, beams, length).expand(bsz, 1, h, beams, length)
        logits = allp.gather(1, idx)[:, 0]  # (B, H, K, L)
        probs = self._softmax(logits, mask)
        w = torch.zeros_like(allp).scatter_(1, idx, probs.unsqueeze(1))
        ctx = torch.bmm(w.view(-1, beams, length), v.reshape(-1, length, dh))
        ctx = ctx.view(bsz, beams, h, beams, dh).float().sum(1).to(self.dtype)
        # (B, H, K, Dh) -> (B*K, H, 1, Dh)
        ctx = ctx.transpose(1, 2).reshape(bsz * beams, h, 1, dh)
        return self._out(ctx)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                anc: Optional[torch.Tensor] = None):
        k_new, v_new = self.project_kv(kv_in)
        if cache is None:
            return self.attend(q_in, k_new, v_new, mask), None
        ck, cv = cache
        # dynamic_update_slice clamps the start into bounds
        i = min(max(int(cache_index), 0), ck.shape[2] - 1)
        ck[:, :, i] = k_new[:, :, 0].to(ck.dtype)
        cv[:, :, i] = v_new[:, :, 0].to(cv.dtype)
        if anc is not None:
            return self.attend_ancestry(q_in, ck, cv, anc, mask), (ck, cv)
        return self.attend(q_in, ck, cv, mask), (ck, cv)


class FFN(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, dtype: torch.dtype,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        if activation not in ("relu", "gelu", "gelu_exact"):
            raise NotImplementedError(activation)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.dtype = dtype
        self.activation = activation
        self.dropout = dropout
        self.tp: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_model(x)
        h = linear(self.fc1, x, self.dtype)
        if self.activation == "relu":
            h = F.relu(h)
        elif self.activation == "gelu":  # GPT-2's gelu_new (tanh approx)
            h = F.gelu(h, approximate="tanh")
        else:  # BERT/RoBERTa erf gelu
            h = F.gelu(h)
        if self.tp is None:
            h = common.dropout(h, self.dropout, self.training)
            return linear(self.fc2, h, self.dtype)
        h = common.dropout(h, self.dropout, self.training, (-1, *self.tp))
        out = reduce_from_model(linear(self.fc2, h, self.dtype,
                                       with_bias=False))
        return out + self.fc2.bias.to(self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, c: TxConfig):
        super().__init__()
        self.normalize_before = c.normalize_before
        self.dropout = c.dropout
        self.self_attn = MultiHeadAttention(c.d_model, c.n_heads, c.dtype,
                                            c.attn_dropout)
        self.self_attn_ln = LayerNorm(c.d_model, c.ln_eps, c.dtype)
        self.ffn = FFN(c.d_model, c.ffn_dim, c.dtype, c.activation,
                       c.act_dropout)
        self.final_ln = LayerNorm(c.d_model, c.ln_eps, c.dtype)

    def _sub(self, x, ln, fn):
        """Residual sub-block, pre- or post-norm, its output dropped out
        before the residual add."""
        def block(y):
            return common.dropout(fn(y), self.dropout, self.training)

        if self.normalize_before:
            return x + block(ln(x))
        return ln(x + block(x))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._sub(x, self.self_attn_ln,
                      lambda y: self.self_attn(y, y, mask)[0])
        return self._sub(x, self.final_ln, self.ffn)


class DecoderLayer(EncoderLayer):
    def __init__(self, c: TxConfig, has_cross: bool = True):
        super().__init__(c)
        self.has_cross = has_cross
        if has_cross:
            self.cross_attn = MultiHeadAttention(c.d_model, c.n_heads, c.dtype,
                                                 c.attn_dropout)
            self.cross_attn_ln = LayerNorm(c.d_model, c.ln_eps, c.dtype)

    def forward(self, x: torch.Tensor, self_mask=None,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                enc_mask=None, self_cache=None, cache_index=None, anc=None,
                enc_out: Optional[torch.Tensor] = None):
        """``enc_kv``: the cross K/V (a decode cache's); else ``enc_out``'s
        are projected here, inside the layer's call, where an fsdp-sharded
        layer's parameters are gathered."""
        new_cache = None
        if self.has_cross and enc_kv is None and enc_out is not None:
            enc_kv = self.cross_attn.project_kv(enc_out)

        def self_block(y):
            nonlocal new_cache
            out, new_cache = self.self_attn(
                y, y, self_mask, cache=self_cache, cache_index=cache_index,
                anc=anc)
            return out

        x = self._sub(x, self.self_attn_ln, self_block)
        if self.has_cross and enc_kv is not None:
            x = self._sub(x, self.cross_attn_ln,
                          lambda y: self.cross_attn.attend(y, *enc_kv, enc_mask))
        return self._sub(x, self.final_ln, self.ffn), new_cache


class _Embeddings(nn.Module):
    """Token embedding (+ learned positions or a sinusoidal table) and the
    layer stack, named ``layers_{i}`` like the flax children."""

    def __init__(self, c: TxConfig, with_tokens: bool = True):
        super().__init__()
        self.cfg = c
        if with_tokens:
            self.embed_tokens = embedding(c.vocab_size, c.d_model,
                                          c.d_model ** -0.5)
        if c.learned_pos:
            self.embed_positions = embedding(c.max_len, c.d_model)
        else:
            self.register_buffer(
                "pos_table",
                torch.from_numpy(sinusoidal_positions(c.max_len, c.d_model)),
                persistent=False)

    def _add_layers(self, layers) -> None:
        self.n_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layers_{i}", layer)

    @property
    def layers(self):
        return [self._modules[f"layers_{i}"] for i in range(self.n_layers)]

    def _pos(self, position0: int, t: int, device) -> torch.Tensor:
        """(T, D) positions from ``position0``; the sinusoidal slice clamps
        its start into the table, as ``lax.dynamic_slice`` does."""
        c = self.cfg
        if c.learned_pos:
            ids = position0 + torch.arange(t, device=device)
            return self.embed_positions(ids).to(c.dtype)
        start = min(max(int(position0), 0), c.max_len - t)
        return self.pos_table[start:start + t].to(c.dtype)


class TransformerEncoder(_Embeddings):
    """Token or embedding encoder (TxEncoderOld/New semantics). Built
    ``with_tokens=False`` where it only ever takes passed-in embeddings
    (flax creates no ``embed_tokens`` parameter there)."""

    def __init__(self, c: TxConfig, with_tokens: bool = True):
        super().__init__(c, with_tokens)
        self._add_layers([EncoderLayer(c) for _ in range(c.n_layers)])

    def forward(self, src_tokens: Optional[torch.Tensor] = None,
                token_embeddings: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                add_positions: bool = True,
                scale_embeddings: Optional[bool] = None) -> torch.Tensor:
        """``scale_embeddings``: apply the sqrt(d_model) embed scale to
        PASSED-IN token_embeddings (fairseq's forward_embedding does; see
        the JAX docstring). None keeps the token-id path's behaviour."""
        c = self.cfg
        if token_embeddings is None:
            assert src_tokens is not None
            token_embeddings = self.embed_tokens(src_tokens).to(c.dtype)
            if pad_mask is None:
                pad_mask = (src_tokens != c.pad_id).long()
            if scale_embeddings is None:
                scale_embeddings = True
        x = token_embeddings
        if c.scale_embed and bool(scale_embeddings):
            x = _scale(x, math.sqrt(c.d_model))
        if add_positions:
            x = x + self._pos(0, x.shape[1], x.device)[None]
        x = common.dropout(x, c.dropout, self.training)
        attn_mask = make_padding_mask(pad_mask)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return x


class TransformerDecoder(_Embeddings):
    """Causal decoder with optional cross-attention: ``forward`` (teacher
    forced), ``build_cache`` and ``decode_step`` (one incremental step)."""

    def __init__(self, c: TxConfig, has_cross: bool = True):
        super().__init__(c)
        self.has_cross = has_cross
        self._add_layers([DecoderLayer(c, has_cross)
                          for _ in range(c.n_layers)])
        if c.final_ln:
            self.ln_f = LayerNorm(c.d_model, c.ln_eps, c.dtype)
        if not c.share_in_out_embed:
            self.output_proj = nn.Linear(c.d_model, c.vocab_size, bias=False)

    def _embed(self, tokens: torch.Tensor, position0: int = 0) -> torch.Tensor:
        c = self.cfg
        x = self.embed_tokens(tokens).to(c.dtype)
        if c.scale_embed:
            x = _scale(x, math.sqrt(c.d_model))
        return x + self._pos(position0, tokens.shape[1], tokens.device)[None]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.final_ln:
            x = self.ln_f(x)
        if c.share_in_out_embed:
            return x @ self.embed_tokens.weight.to(x.dtype).t()
        return linear(self.output_proj, x, c.dtype)

    def forward(self, tokens: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None,
                enc_pad_mask: Optional[torch.Tensor] = None,
                self_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = common.dropout(self._embed(tokens), self.cfg.dropout,
                           self.training)
        mask = make_causal_mask(tokens.shape[1], tokens.device)
        if self_pad_mask is not None:
            mask = mask + make_padding_mask(self_pad_mask)
        enc_mask = make_padding_mask(enc_pad_mask)
        for layer in self.layers:
            x, _ = layer(x, mask, enc_mask=enc_mask, enc_out=enc_out)
        return self._logits(x)

    def build_cache(self, batch: int, max_len: int,
                    enc_out: Optional[torch.Tensor] = None) -> Cache:
        """Self K/V zeros of (batch, H, max_len, Dh) in the compute dtype
        (H: the layer's heads, this rank's under tensor parallelism), plus
        the cross K/V of ``enc_out``, computed once."""
        c = self.cfg
        dh = c.d_model // c.n_heads
        dev = self.embed_tokens.weight.device
        cache: Cache = {"layers": []}
        for layer in self.layers:
            heads = layer.self_attn.n_heads
            entry = {
                name: torch.zeros(batch, heads, max_len, dh,
                                  dtype=c.dtype, device=dev)
                for name in ("self_k", "self_v")
            }
            if self.has_cross and enc_out is not None:
                entry["cross_k"], entry["cross_v"] = (
                    layer.cross_attn.project_kv(enc_out))
            cache["layers"].append(entry)
        return cache

    def decode_step(self, token: torch.Tensor, position: int, cache: Cache,
                    enc_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (R, 1) at ``position`` -> (logits (R, 1, V), cache). The
        cache's self K/V are written in place; ``cache["anc"]``, when
        present, selects ancestor slots (ancestry-mode beam decode).
        Deterministic in either mode, as the JAX package's."""
        with common.deterministic():
            return self._decode_step(token, position, cache, enc_mask)

    def _decode_step(self, token, position, cache, enc_mask):
        x = self._embed(token, position0=position)
        max_len = cache["layers"][0]["self_k"].shape[2]
        pos_ids = torch.arange(max_len, device=token.device)
        step_mask = torch.where(pos_ids <= position, 0.0, NEG_INF)[
            None, None, None, :]
        anc = cache.get("anc")
        for layer, entry in zip(self.layers, cache["layers"]):
            enc_kv = ((entry["cross_k"], entry["cross_v"])
                      if ("cross_k" in entry and self.has_cross) else None)
            x, _ = layer(x, self_mask=step_mask, enc_kv=enc_kv,
                         enc_mask=enc_mask,
                         self_cache=(entry["self_k"], entry["self_v"]),
                         cache_index=position, anc=anc)
        return self._logits(x), cache
