"""SRL generation (port of vidsitu_tpu/gen/generate.py; reference:
forward_gen, mdl_sf_base.py:657-675)."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models.common import make_padding_mask
from ..models.srl_models import SRLModel
from ..parallel.collectives import model_group, model_world_size
from .beam import (
    BeamOutput,
    GenConfig,
    ancestry_reorder,
    beam_search,
    tile_for_beams,
)

SRL_DECODE_LEN = 60  # fallback when cfg.gen.max_len_b is unset (<=0)


class SRLGenerator:
    """``generator(inp) -> (B, 5, 1, max_len + 1)`` top-beam tokens.

    Decoding is verb-forced: it starts from eos-as-bos and the first
    generated token is forced to the event's verb token (prefix_tokens,
    mdl_sf_base.py:660-663). With ``ancestry`` and beam > 1 the KV cache
    stays slot-major and only an ancestry table is permuted each step;
    otherwise every beam step reorders the whole cache (``_gather_beams``:
    the row-gather kernel on a GPU). With ``seg_min`` > 0 the cache starts
    at ``seg_min`` + 1 positions and doubles between segments, token-exact
    against one segment.

    Under tensor parallelism (``parallel/tensor.py``) each rank of a model
    group decodes the same rows with its own heads: its cache holds H / n
    heads, its cross K/V come from its own projections and its reorders
    move its own cache (the row-gather kernel, one launch a step on every
    rank). The logits leave the all-reduce equal on every rank, so every
    host decision (finished hypotheses, the stop) is the same and the ranks
    stay in lockstep; the tokens and steps are compared at the end of each
    search, and a parting raises.

    ``steps`` lists the decode steps each call took."""

    def __init__(self, model: SRLModel, gen_cfg: GenConfig, vocab_size: int,
                 pad_id: int, bos_id: int, eos_id: int, unk_id=None,
                 max_len: int = 0, max_positions: int = 1024,
                 ancestry: bool = True, seg_min: int = 64):
        if max_len <= 0:
            max_len = (gen_cfg.max_len_b if gen_cfg.max_len_b > 0
                       else SRL_DECODE_LEN)
            # fairseq budget max_len_a * src_len + max_len_b; the SRL
            # models' src_len is the single forced verb token
            max_len += int(gen_cfg.max_len_a) * 1
        self.max_len = min(max_len, max_positions - 1)
        self.model = model
        self.gen_cfg = gen_cfg
        self.vocab_size, self.pad_id = vocab_size, pad_id
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.ancestry = ancestry
        n_steps = self.max_len + 1
        bounds: tuple = ()
        if seg_min and seg_min > 0:
            b = int(seg_min)
            while b < n_steps:
                bounds += (b,)
                b *= 2
        self.seg_bounds = bounds
        self.cache_len0 = (bounds[0] + 1) if bounds else (self.max_len + 1)
        self.steps: List[int] = []

    def _grow_cache(self, cache: Dict[str, Any], new_len: int):
        """Zero-pad the self K/V (and the ancestry table, with identity
        columns) from the current segment length to ``new_len``."""
        out = dict(cache)
        layers = []
        for entry in cache["layers"]:
            e2 = dict(entry)
            for key in ("self_k", "self_v"):
                x = entry[key]  # (rows, H, L, Dh)
                pad = x.new_zeros(x.shape[:2] + (new_len - x.shape[2],)
                                  + x.shape[3:])
                e2[key] = torch.cat([x, pad], dim=2)
            layers.append(e2)
        out["layers"] = layers
        if "anc" in cache:
            a = cache["anc"]
            ident = torch.arange(a.shape[1], dtype=a.dtype, device=a.device)
            ident = ident[None, :, None].expand(a.shape[0], -1,
                                                new_len - a.shape[2])
            out["anc"] = torch.cat([a, ident], dim=2)
        return out

    @torch.inference_mode()
    def search(self, inp: Dict[str, torch.Tensor]) -> BeamOutput:
        """Every beam of every event: seqs (B*5, K, max_len + 1)."""
        k = self.gen_cfg.beam_size
        toks = inp["seq_out_by_ev"][:, :, 0, :]
        rows = toks.shape[0] * 5
        prefix = toks.reshape(rows, -1)[:, :1]
        model = self.model
        enc_out, enc_mask = model.gen_encode(inp)
        if enc_out is not None:
            enc_out = tile_for_beams(enc_out, k)
        m = (make_padding_mask(tile_for_beams(enc_mask, k))
             if enc_mask is not None else None)
        cache = model.gen_build_cache(rows * k, self.cache_len0, enc_out)
        reorder_fn = None
        if self.ancestry and k > 1:
            cache["anc"] = torch.arange(k, device=prefix.device)[
                None, :, None].repeat(rows, 1, self.cache_len0)
            reorder_fn = ancestry_reorder

        def step_fn(last_tok, pos, cache_):
            logits, cache2 = model.gen_decode_step(last_tok, pos, cache_, m)
            return logits[:, 0], cache2

        out = beam_search(
            step_fn, cache, batch_size=rows, max_len=self.max_len,
            bos_id=self.bos_id, eos_id=self.eos_id, pad_id=self.pad_id,
            vocab_size=self.vocab_size, gen_cfg=self.gen_cfg,
            prefix_tokens=prefix, unk_id=self.unk_id,
            reorder_cache_fn=reorder_fn,
            seg_bounds=self.seg_bounds or None,
            grow_cache_fn=self._grow_cache if self.seg_bounds else None,
        )
        if model_world_size() > 1:
            same_on_model_group(out)
        self.steps.append(out.steps)
        return out

    def __call__(self, inp: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Top beam only, shaped like the reference's out_sents (B, 5, 1,
        max_len + 1)."""
        seqs = self.search(inp).seqs
        return seqs[:, 0].reshape(-1, 5, 1, seqs.shape[-1])


def same_on_model_group(out: BeamOutput) -> None:
    """Raise unless every rank of the model group holds the same tokens and
    steps (one all-reduce of their maximum and of their negated minimum)."""
    mine = torch.cat([out.seqs.reshape(-1),
                      out.seqs.new_tensor([out.steps])])
    both = torch.cat([mine, -mine])
    torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX,
                                 group=model_group())
    hi, neg_lo = both.split(mine.numel())
    if not (torch.equal(hi, mine) and torch.equal(-neg_lo, mine)):
        raise RuntimeError(
            "the ranks of a model group decoded different tokens or steps")


def make_srl_generator(model: SRLModel, gen_cfg: GenConfig, vocab_size: int,
                       pad_id: int, bos_id: int, eos_id: int, unk_id=None,
                       max_len: int = 0, max_positions: int = 1024,
                       ancestry: bool = True, seg_min: int = 64
                       ) -> SRLGenerator:
    """The JAX package's ``make_srl_generator`` signature (no mesh: one
    device)."""
    return SRLGenerator(model, gen_cfg, vocab_size, pad_id, bos_id, eos_id,
                        unk_id=unk_id, max_len=max_len,
                        max_positions=max_positions, ancestry=ancestry,
                        seg_min=seg_min)
