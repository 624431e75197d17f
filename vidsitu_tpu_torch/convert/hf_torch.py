"""Weight converters: HF/torch checkpoints -> vidsitu_tpu param trees.

The reference consumes pretrained ``gpt2-medium`` and ``roberta-base``
via HF ``from_pretrained`` (mdl_sf_base.py:562, mdl_evrel.py:21,62). In a
TPU-native deployment the published torch weights are converted once to
our flax trees with these functions; parity is covered by tests that
compare logits against the torch models on random weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .tracking import TrackedDict, verify_exhausted

# non-parameter keys legitimately absent from the converted tree
_GPT2_IGNORE = (
    r"^lm_head\.weight$",          # tied to wte
    r"\.attn\.(bias|masked_bias)$",  # causal-mask buffers
)
_ROBERTA_IGNORE = (
    r"position_ids$",   # buffer
    r"^lm_head\.",      # MLM head (unused by the encoder consumer)
    r"^classifier\.",   # task head is built fresh (ref mdl_evrel.py:21-24)
)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()}


def _resize_rows(
    w: np.ndarray, target: int, rng: np.random.Generator, std: float = 0.02
) -> np.ndarray:
    if target <= w.shape[0]:
        return w[:target]
    extra = rng.normal(0.0, std, size=(target - w.shape[0], w.shape[1]))
    return np.concatenate([w, extra.astype(w.dtype)], axis=0)


def convert_gpt2(
    sd: Dict[str, np.ndarray],
    n_layers: int,
    n_heads: int,
    target_vocab: Optional[int] = None,
    seed: int = 0,
    strict: bool = False,
) -> Dict[str, Any]:
    """HF GPT2LMHeadModel state dict -> TransformerDecoder params
    (pre-norm, gelu, learned positions, tied in/out embeddings).

    ``target_vocab`` resizes the token embedding for added tokens
    (HF resize_token_embeddings semantics: new rows ~ N(0, 0.02)).
    ``strict`` asserts every source key is consumed (or a known
    buffer/tied weight) — full-checkpoint schema fidelity.
    """
    sd = TrackedDict(dict(sd))
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    rng = np.random.default_rng(seed)
    wte = sd[f"{pre}wte.weight"]
    if target_vocab is not None:
        wte = _resize_rows(wte, target_vocab, rng)
    d = wte.shape[1]
    dh = d // n_heads
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": wte},
        "embed_positions": {"embedding": sd[f"{pre}wpe.weight"]},
        "ln_f": {
            "scale": sd[f"{pre}ln_f.weight"],
            "bias": sd[f"{pre}ln_f.bias"],
        },
    }
    for i in range(n_layers):
        h = f"{pre}h.{i}."
        # HF Conv1D stores (in, out): no transpose needed for x @ W
        ca_w = sd[h + "attn.c_attn.weight"]  # (d, 3d)
        ca_b = sd[h + "attn.c_attn.bias"]  # (3d,)
        qw, kw, vw = np.split(ca_w, 3, axis=1)
        qb, kb, vb = np.split(ca_b, 3, axis=0)
        cp_w = sd[h + "attn.c_proj.weight"]  # (d, d)
        layer = {
            "self_attn_ln": {
                "scale": sd[h + "ln_1.weight"],
                "bias": sd[h + "ln_1.bias"],
            },
            "self_attn": {
                "q_proj": {"kernel": qw.reshape(d, n_heads, dh),
                           "bias": qb.reshape(n_heads, dh)},
                "k_proj": {"kernel": kw.reshape(d, n_heads, dh),
                           "bias": kb.reshape(n_heads, dh)},
                "v_proj": {"kernel": vw.reshape(d, n_heads, dh),
                           "bias": vb.reshape(n_heads, dh)},
                "out_proj": {"kernel": cp_w.reshape(n_heads, dh, d),
                             "bias": sd[h + "attn.c_proj.bias"]},
            },
            "final_ln": {
                "scale": sd[h + "ln_2.weight"],
                "bias": sd[h + "ln_2.bias"],
            },
            "ffn": {
                "fc1": {"kernel": sd[h + "mlp.c_fc.weight"],
                        "bias": sd[h + "mlp.c_fc.bias"]},
                "fc2": {"kernel": sd[h + "mlp.c_proj.weight"],
                        "bias": sd[h + "mlp.c_proj.bias"]},
            },
        }
        params[f"layers_{i}"] = layer
    if strict:
        verify_exhausted(sd, _GPT2_IGNORE, "convert_gpt2")
    return params


def convert_roberta(
    sd: Dict[str, np.ndarray],
    n_layers: int,
    n_heads: int,
    strict: bool = False,
) -> Dict[str, Any]:
    """HF RobertaModel state dict -> our RobertaModel params. ``strict``
    asserts full source-key consumption (modulo buffers/aux heads)."""
    sd = TrackedDict(dict(sd))
    pre = "roberta." if any(k.startswith("roberta.") for k in sd) else ""
    emb = f"{pre}embeddings."
    enc = f"{pre}encoder.layer."

    def lin(name):  # torch Linear (out,in) -> (in,out)
        return {
            "kernel": sd[name + ".weight"].T,
            "bias": sd[name + ".bias"],
        }

    d = sd[emb + "word_embeddings.weight"].shape[1]
    dh = d // n_heads

    def attn_lin(name):
        k = sd[name + ".weight"].T  # (in d, out d)
        return {
            "kernel": k.reshape(d, n_heads, dh),
            "bias": sd[name + ".bias"].reshape(n_heads, dh),
        }

    params: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd[emb + "word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd[emb + "position_embeddings.weight"]
        },
        "token_type_embeddings": {
            "embedding": sd[emb + "token_type_embeddings.weight"]
        },
        "emb_ln": {
            "scale": sd[emb + "LayerNorm.weight"],
            "bias": sd[emb + "LayerNorm.bias"],
        },
    }
    if f"{pre}pooler.dense.weight" in sd:
        params["pooler_dense"] = lin(f"{pre}pooler.dense")
    for i in range(n_layers):
        L = f"{enc}{i}."
        out_w = sd[L + "attention.output.dense.weight"].T  # (d, d)
        params[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": attn_lin(L + "attention.self.query"),
                "k_proj": attn_lin(L + "attention.self.key"),
                "v_proj": attn_lin(L + "attention.self.value"),
                "out_proj": {
                    "kernel": out_w.reshape(n_heads, dh, d),
                    "bias": sd[L + "attention.output.dense.bias"],
                },
            },
            "self_attn_ln": {
                "scale": sd[L + "attention.output.LayerNorm.weight"],
                "bias": sd[L + "attention.output.LayerNorm.bias"],
            },
            "ffn": {
                "fc1": lin(L + "intermediate.dense"),
                "fc2": lin(L + "output.dense"),
            },
            "final_ln": {
                "scale": sd[L + "output.LayerNorm.weight"],
                "bias": sd[L + "output.LayerNorm.bias"],
            },
        }
    if strict:
        verify_exhausted(sd, _ROBERTA_IGNORE, "convert_roberta")
    return params
