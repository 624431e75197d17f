"""Model and generator selection by (task_type, mdl.mdl_name) (port of
vidsitu_tpu/models/selector.py; reference: vidsitu_code/mdl_selector.py)."""

from __future__ import annotations

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtypes(cfg):
    """(compute dtype, parameter dtype) from ``train.dtype`` and
    ``train.param_dtype``."""
    return DTYPES[cfg.train.dtype], DTYPES[cfg.train.param_dtype]


def build_model(cfg, comm):
    """The model for ``cfg`` (selector.py:26-73): the ``vb`` verb model, a
    ``vb_arg`` model or an ``evrel`` model. Parameters are held in
    ``train.param_dtype`` (BatchNorm statistics in float32), the products
    run in ``train.dtype``."""
    task = cfg.task_type
    if task == "vb":
        from .vb_models import build_vb_model

        return build_vb_model(cfg, comm)
    if task == "evrel":
        from .evrel_models import build_evrel_model

        return build_evrel_model(cfg, comm)
    if task != "vb_arg":
        raise NotImplementedError(task)
    tok = comm.gpt2_hf_tok
    return build_srl_model(cfg, len(tok), tok.pad_token_id)


def build_srl_model(cfg, vocab_size: int, pad_id: int):
    """The ``vb_arg`` model ``mdl.mdl_name`` over a vocabulary of
    ``vocab_size`` tokens (the tokenizer's, or a larger one to time the
    output layer at GPT-2's size), its parameters in ``train.param_dtype``."""
    from .common import cast_params
    from .srl_models import SRL_MDL_NAMES, FEAT_MDLS, SRLModel, get_head_dim
    from .transformer import TxConfig

    mdl_name = cfg.mdl.mdl_name
    if mdl_name not in SRL_MDL_NAMES:
        raise ValueError(f"unknown vb_arg model {mdl_name}")
    dtype, param_dtype = compute_dtypes(cfg)
    if mdl_name == "new_gpt2_only":
        # GPT-2 architecture (pre-norm, gelu, learned positions, tied in/out
        # embeddings), dims from cfg.gpt2_mdl
        g = cfg.gpt2_mdl
        dec_cfg = TxConfig(
            vocab_size=vocab_size, d_model=g.d_model, ffn_dim=4 * g.d_model,
            n_layers=g.n_layers, n_heads=g.n_heads, dropout=0.1,
            max_len=g.max_pos, normalize_before=True, scale_embed=False,
            learned_pos=True, share_in_out_embed=True,
            pad_id=pad_id, activation="gelu", final_ln=True,
            dtype=dtype,
        )
    else:
        dec_cfg = TxConfig.from_cfg(cfg.tx_dec, vocab_size, pad_id,
                                    side="decoder", dtype=dtype)
    enc_cfg = TxConfig.from_cfg(cfg.tx_dec, vocab_size, pad_id,
                                side="encoder", dtype=dtype)
    return cast_params(SRLModel(
        mdl_name=mdl_name, dec_cfg=dec_cfg, enc_cfg=enc_cfg,
        tx_enc_type=cfg.mdl.tx_enc_type,
        feat_dim=get_head_dim(cfg) if mdl_name in FEAT_MDLS else 0,
    ), param_dtype)


def init_model_variables(model, seed: int = 0):
    """flax's default initial values for any model of the port, drawn from
    ``seed`` (``common.init_like_flax``); returns the model. The JAX package
    draws them with ``model.init`` from ``PRNGKey(seed)``: the values differ,
    the distributions and the zero-initialised scales match."""
    from .common import init_like_flax

    return init_like_flax(model, seed)


def build_srl_generate_fn(cfg, comm, model):
    """The SRL generator for ``model`` (selector.py:87-112): decode length
    capped by the decoder's position table, decoding from eos-as-bos with
    the verb forced, ``tpu.ancestry_beam`` and ``tpu.seg_decode_min`` read
    from the same keys as the JAX package."""
    from ..gen.beam import GenConfig
    from ..gen.generate import make_srl_generator

    tok = comm.gpt2_hf_tok
    if "gpt2" in cfg.mdl.mdl_name:
        # the configured position-table size: a shrunk gpt2_mdl.max_pos
        # must cap the decode length (learned positions)
        max_positions = int(cfg.gpt2_mdl.max_pos)
    else:
        max_positions = int(cfg.tx_dec["max_target_positions"])
    return make_srl_generator(
        model,
        GenConfig.from_cfg(cfg.gen),
        vocab_size=len(tok),
        pad_id=tok.pad_token_id,
        bos_id=tok.eos_token_id,  # decode starts from eos-as-bos
        eos_id=tok.eos_token_id,
        unk_id=tok.unk_token_id,
        max_positions=max_positions,
        ancestry=bool(cfg.tpu.get("ancestry_beam", True)),
        seg_min=int(cfg.tpu.get("seg_decode_min", 64)),
    )
