"""SRL (vb_arg) task models (port of vidsitu_tpu/models/srl_models.py).

One module covers the five variants of the reference model zoo
(mdl_sf_base.py:590-832), selected by ``mdl_name``:

  * ``tx_only``              — decoder-only LM over per-event role sequences
  * ``new_gpt2_only``        — the same, GPT-2 flavoured
  * ``txed_only``            — + token encoder over the 5 verb tokens
  * ``sfpret_txed_vbarg``    — video-feature MLP -> per-event memory
  * ``sfpret_txe_txd_vbarg`` — + transformer over the 5 event features

The (B, 5 events) axis is folded into the batch, so all 5 events of a
segment decode together. ``forward`` is the training forward: in
``train()`` it drops out at the transformer's sites (models/transformer.py),
drawing from the generator of ``common.dropout_generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.collectives import data_group, data_world_size
from . import common
from .common import MLP
from .transformer import TransformerDecoder, TransformerEncoder, TxConfig

SRL_MDL_NAMES = (
    "tx_only",
    "new_gpt2_only",  # GPT-2-flavored decoder-only LM (Simple_GPT2_New)
    "txed_only",
    "sfpret_txed_vbarg",
    "sfpret_txe_txd_vbarg",
)
FEAT_MDLS = ("sfpret_txed_vbarg", "sfpret_txe_txd_vbarg")


def get_head_dim(full_cfg) -> int:
    """Feature dim from the features-dir name (mdl_sf_base.py:751-760)."""
    d = full_cfg.ds.vsitu.vsit_frm_feats_dir
    if "i3d" in d:
        return 2048
    if "slow_fast" in d or "sfast" in d:
        return 2304
    raise NotImplementedError(f"cannot infer feature dim from {d}")


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """Mean CE over non-pad labels, in float32 (float64 for float64
    logits, so that a float64 step keeps its precision), 0 when every label
    is pad. The pad label is replaced by class 0 before the gather and masked
    after it, so a pad id outside the classes (the verb task's -1) works as
    it does in the JAX package.

    Under a process group of several ranks, with autograd on, the
    denominator is the count of non-pad labels over the data group (every
    rank, or under tensor parallelism the ranks that split the batch;
    all-reduced, no gradient): each rank returns its share of the global
    batch's mean, the ranks' shares sum to it, and so do their gradients
    (``Learner`` sums them over the data group)."""
    labels = labels.reshape(-1)
    mask = labels != pad_id
    stat = torch.promote_types(logits.dtype, torch.float32)
    ce = F.cross_entropy(logits.to(stat).reshape(-1, logits.shape[-1]),
                         torch.where(mask, labels, 0), reduction="none")
    mask = mask.to(stat)
    count = mask.sum()
    if data_world_size() > 1 and torch.is_grad_enabled():
        count = count.detach().clone()
        torch.distributed.all_reduce(count, group=data_group())
    return (ce * mask).sum() / count.clamp(min=1.0)


class SRLModel(nn.Module):
    """``tx_enc_type`` mirrors cfg.mdl.tx_enc_type (mdl_sf_base.py:423-432):
    'old' adds sinusoidal positions and the sqrt(d) scale (fairseq
    TxEncoderOld), 'new' encodes raw embeddings, 'new_conc' concatenates
    input and encoder output through an MLP. ``feat_dim`` is the input
    width of the feature MLP (``get_head_dim``)."""

    def __init__(self, mdl_name: str, dec_cfg: TxConfig,
                 enc_cfg: Optional[TxConfig] = None, tx_enc_type: str = "new",
                 feat_dim: int = 2048):
        super().__init__()
        if mdl_name not in SRL_MDL_NAMES:
            raise ValueError(f"unknown vb_arg model {mdl_name}")
        self.mdl_name = mdl_name
        self.dec_cfg = dec_cfg
        self.enc_cfg = enc_cfg
        self.feat_dim = feat_dim
        self.tx_enc_type = tx_enc_type
        self.has_cross = mdl_name not in ("tx_only", "new_gpt2_only")
        self.decoder = TransformerDecoder(dec_cfg, has_cross=self.has_cross)
        d = dec_cfg.d_model
        if mdl_name in FEAT_MDLS:
            self.vid_feat_encoder = MLP(feat_dim, [d, d], dtype=dec_cfg.dtype)
        if mdl_name == "sfpret_txe_txd_vbarg":
            self.vid_feat_txenc = TransformerEncoder(enc_cfg, with_tokens=False)
            if tx_enc_type == "new_conc":
                self.txenc_conc = MLP(2 * d, [d, d], dtype=dec_cfg.dtype)
        if mdl_name == "txed_only":
            self.encoder = TransformerEncoder(enc_cfg)

    def encode(self, inp: Dict[str, torch.Tensor]
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(enc_out (B*5, S, D), enc_pad_mask (B*5, S)) or Nones."""
        if not self.has_cross:
            return None, None
        if self.mdl_name == "txed_only":
            vb_toks = inp["vb_out_by_ev"][:, :, 0, :]  # (B, 5, 5)
            vb_flat = vb_toks.reshape(-1, vb_toks.shape[-1])
            pad_mask = (vb_flat != self.dec_cfg.pad_id).long()
            return self.encoder(src_tokens=vb_flat, pad_mask=pad_mask), pad_mask
        frm_feats = inp["frm_feats"]  # (B, 5, D)
        b = frm_feats.shape[0]
        out = self.vid_feat_encoder(frm_feats.to(self.dec_cfg.dtype))
        if self.mdl_name == "sfpret_txed_vbarg":
            return out.reshape(b * 5, 1, -1), None
        fairseq_like = self.tx_enc_type in ("old", "new_conc")
        ctx = self.vid_feat_txenc(token_embeddings=out,
                                  add_positions=fairseq_like,
                                  scale_embeddings=fairseq_like)
        if self.tx_enc_type == "new_conc":
            ctx = self.txenc_conc(torch.cat([out, ctx], dim=-1))
        return ctx.reshape(b * 5, 1, -1), None

    def teacher_forced_logits(self, inp: Dict[str, torch.Tensor]
                              ) -> torch.Tensor:
        """(B*5, 60, V) logits of the UNSHIFTED sequence [verb, args...,
        eos] (the reference feeds it as prev_tokens and losses logits[:-1]
        against toks[1:]; see the JAX module's note)."""
        toks = inp["seq_out_by_ev"][:, :, 0, :]
        enc_out, enc_mask = self.encode(inp)
        return self.decoder(toks.reshape(-1, toks.shape[-1]), enc_out=enc_out,
                            enc_pad_mask=enc_mask)

    def forward(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        toks = inp["seq_out_by_ev"][:, :, 0, :]
        toks_flat = toks.reshape(-1, toks.shape[-1])
        logits = self.teacher_forced_logits(inp)
        loss = masked_cross_entropy(logits[:, :-1], toks_flat[:, 1:],
                                    self.dec_cfg.pad_id)
        return {"loss": loss}

    # -- generation plumbing (deterministic in either mode) -----------------
    def gen_encode(self, inp):
        with common.deterministic():
            return self.encode(inp)

    def gen_build_cache(self, batch: int, max_len: int, enc_out):
        return self.decoder.build_cache(batch, max_len, enc_out)

    def gen_decode_step(self, token, position, cache, enc_mask=None):
        return self.decoder.decode_step(token, position, cache, enc_mask)
