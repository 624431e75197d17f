"""Event-relation (evrel) models (port of vidsitu_tpu/models/evrel_models.py;
reference: vidsitu_code/mdl_evrel.py), the five variants in one module:

  * ``rob_evrel``            — RoBERTa sequence classifier over the pair
                               sequences against Ev3
  * ``sfpret_evrel``         — RoBERTa pooler per event + video-feature MLP
                               -> vis-lang encoder -> pairs [0,1,2,2] x
                               [2,2,3,4] -> 5-way classifier
  * ``sfpret_vbonly_evrel``  — language input = the verb tokens only
  * ``sfpret_onlyvid_evrel`` — language zeroed
  * ``txe_evrel``            — video zeroed

``forward`` returns the logits ``mdl_out`` (B, 4, N, 5) and the loss, a
cross-entropy over the labels that are not -1.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .common import MLP
from .roberta import RobertaCfg, RobertaClassificationHead, RobertaModel
from .srl_models import masked_cross_entropy

EVREL_MDL_NAMES = (
    "rob_evrel",
    "txe_evrel",
    "sfpret_evrel",
    "sfpret_vbonly_evrel",
    "sfpret_onlyvid_evrel",
)

NUM_EVREL_LABELS = 5
PAIR_IDX_A = (0, 1, 2, 2)
PAIR_IDX_B = (2, 2, 3, 4)
VIS_DIM = 1024  # the reference's video / vis-lang width (mdl_evrel.py)


class EvrelModel(nn.Module):
    """``feat_dim`` is the width of ``frm_feats`` (``get_head_dim``), the
    input of the video-feature MLP; flax infers it from the first batch."""

    def __init__(self, mdl_name: str, rob_cfg: RobertaCfg,
                 feat_dim: int = 2048):
        super().__init__()
        if mdl_name not in EVREL_MDL_NAMES:
            raise ValueError(f"unknown evrel model {mdl_name}")
        self.mdl_name = mdl_name
        self.rob_cfg = c = rob_cfg
        self.feat_dim = feat_dim
        d = VIS_DIM
        if mdl_name == "rob_evrel":
            self.rob_mdl = RobertaModel(c, add_pooling_layer=False)
            self.classf_head = RobertaClassificationHead(
                c.d_model, NUM_EVREL_LABELS, dtype=c.dtype, dropout=c.dropout)
            return
        # sfpret_onlyvid_evrel registers rob_mdl although its forward is
        # skipped: the parameter set (and a strict load) matches the
        # reference's state_dict and the JAX package's tree
        self.rob_mdl = RobertaModel(c, add_pooling_layer=True)
        self.vid_feat_encoder = MLP(feat_dim, [d, d], dtype=c.dtype)
        self.vis_lang_encoder = MLP(d + c.d_model, [d, d], dtype=c.dtype)
        self.vis_lang_classf = MLP(2 * d, [d, NUM_EVREL_LABELS],
                                   dtype=c.dtype)
        self.register_buffer("pair_a", torch.tensor(PAIR_IDX_A),
                             persistent=False)
        self.register_buffer("pair_b", torch.tensor(PAIR_IDX_B),
                             persistent=False)

    def _get_src(self, inp):
        if self.mdl_name == "sfpret_vbonly_evrel":
            return inp["evrel_vbonly_out_ones"], inp["evrel_vbonly_out_ones_lens"]
        return inp["evrel_seq_out_ones"], inp["evrel_seq_out_ones_lens"]

    def logits(self, inp: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, 4, N, 5) relation logits in the compute dtype."""
        c = self.rob_cfg
        if self.mdl_name == "rob_evrel":
            toks = inp["evrel_seq_out"]  # (B, 4, N, 120)
            b, nev, nann, slen = toks.shape
            hidden = self.rob_mdl(
                toks.reshape(-1, slen),
                inp["evrel_seq_out_lens"].reshape(-1, slen))["last_hidden_state"]
            return self.classf_head(hidden).reshape(b, nev, nann,
                                                    NUM_EVREL_LABELS)
        toks, lens = self._get_src(inp)  # (B, 5, N, L)
        b, _, nann, slen = toks.shape
        if self.mdl_name == "sfpret_onlyvid_evrel":
            # the language pathway is zeroed for this ablation: its forward
            # would be multiplied by zero, so it is skipped
            pooler5 = torch.zeros((b, 5, nann, c.d_model), dtype=c.dtype,
                                  device=toks.device)
        else:
            pooler = self.rob_mdl(toks.reshape(-1, slen),
                                  lens.reshape(-1, slen))["pooler_output"]
            pooler5 = pooler.reshape(b, 5, nann, -1)
        vis = self.vid_feat_encoder(inp["frm_feats"].to(c.dtype))  # (B,5,1024)
        vis = vis[:, :, None, :].expand(b, 5, nann, vis.shape[-1])
        if self.mdl_name == "txe_evrel":
            vis = torch.zeros_like(vis)
        vis_lang = self.vis_lang_encoder(torch.cat([vis, pooler5], dim=-1))
        pairs = torch.cat([vis_lang.index_select(1, self.pair_a),
                           vis_lang.index_select(1, self.pair_b)], dim=-1)
        return self.vis_lang_classf(pairs)  # (B, 4, N, 5)

    def forward(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        logits = self.logits(inp)
        loss = masked_cross_entropy(logits.reshape(-1, NUM_EVREL_LABELS),
                                    inp["evrel_labs"].reshape(-1), pad_id=-1)
        return {"loss": loss, "mdl_out": logits}


def build_evrel_model(cfg, comm) -> EvrelModel:
    """The evrel model of ``cfg`` (evrel_models.py:138-158): roberta dims
    from ``cfg.rob_mdl``, the vocabulary and pad id of the RoBERTa
    tokenizer, parameters in ``train.param_dtype``, products in
    ``train.dtype``."""
    from .common import cast_params
    from .selector import compute_dtypes
    from .srl_models import get_head_dim

    dtype, param_dtype = compute_dtypes(cfg)
    tok = comm.rob_hf_tok
    rc = cfg.rob_mdl
    # HF RoBERTa offsets positions by pad_id (1 in the published
    # checkpoint); a vocabulary built from scratch can have a large pad id,
    # so the table covers pad_id + the longest sequence (120)
    max_pos = max(rc.max_pos, tok.pad_token_id + 122)
    rob_cfg = RobertaCfg(
        vocab_size=len(tok), d_model=rc.d_model, n_layers=rc.n_layers,
        n_heads=rc.n_heads, ffn_dim=rc.ffn_dim, max_pos=max_pos,
        pad_id=tok.pad_token_id, dtype=dtype)
    feat_dim = (0 if cfg.mdl.mdl_name == "rob_evrel" else get_head_dim(cfg))
    return cast_params(EvrelModel(cfg.mdl.mdl_name, rob_cfg, feat_dim),
                       param_dtype)
