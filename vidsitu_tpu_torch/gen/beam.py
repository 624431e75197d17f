"""Beam search / greedy decoding (port of vidsitu_tpu/gen/beam.py).

The JAX package runs the search as a ``lax.while_loop`` over static shapes
with a dual beam state (alive / finished) that reproduces fairseq's
SequenceGenerator (seq_gen.py:190-772) exactly; see that module's
docstring for the semantics. Here the loop is a Python loop over steps with
the same early exit (every sentence's finalized quota full), checked on the
host once per step: the step's one host sync.

Points where torch differs from XLA and the port does what XLA does:

  * ``jax.lax.top_k`` takes the lower index first among equal values;
    ``torch.topk`` promises no order. Every top-k here is ``top_k``: a
    stable descending sort, then a slice.
  * ``lax.dynamic_slice`` / ``dynamic_update_slice`` clamp the start into
    bounds; the port clamps the same starts by hand.
  * ``jnp.repeat`` is ``repeat_interleave``: rows are [b0 x K, b1 x K, ...].

The KV-cache reorder of a beam step (``_gather_beams``) moves every float
leaf of the cache in one launch of the row-gather kernel on a GPU
(ops/beam_gather.py), and takes its plain version on the CPU. Under tensor
parallelism the cache holds this rank's heads, and each rank reorders its
own (gen/generate.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from ..ops.beam_gather import gather_rows

NEG_INF = -1e9


@dataclass(frozen=True)
class GenConfig:
    """Mirror of cfg.gen (configs/vsitu_cfg.yml:93-102)."""

    beam_size: int = 1
    max_len_a: int = 0
    max_len_b: int = 200
    min_len: int = 0
    normalize_scores: bool = True
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    temperature: float = 1.0
    no_repeat_ngram_size: int = 0

    @classmethod
    def from_cfg(cls, gen_cfg) -> "GenConfig":
        return cls(
            beam_size=int(gen_cfg.beam_size),
            max_len_a=int(gen_cfg.max_len_a),
            max_len_b=int(gen_cfg.max_len_b),
            min_len=int(gen_cfg.min_len),
            normalize_scores=bool(gen_cfg.normalize_scores),
            len_penalty=float(gen_cfg.len_penalty),
            unk_penalty=float(gen_cfg.unk_penalty),
            temperature=float(gen_cfg.temperature),
            no_repeat_ngram_size=int(gen_cfg.no_repeat_ngram_size),
        )


class BeamOutput(NamedTuple):
    seqs: torch.Tensor  # (B, K, max_len+1), bos stripped, pad after eos
    scores: torch.Tensor  # (B, K) float32, sorted descending
    lengths: torch.Tensor  # (B, K) incl. eos
    steps: int  # decode steps taken (step_fn calls)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: the k largest values, ties
    broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves of a tree of dicts/lists/tuples, and its rebuild function."""
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        keys = list(tree)
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        keys = None
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new: List[Any]) -> Any:
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(x) for x in leaves])


def tile_for_beams(tree: Any, beam_size: int) -> Any:
    """Repeat every leaf along axis 0: (B, ...) -> (B*beam, ...), rows
    [b0 x beam, b1 x beam, ...] (``jnp.repeat``; fairseq's reorder
    convention, seq_gen.py:253-255)."""
    return tree_map(lambda x: x.repeat_interleave(beam_size, dim=0), tree)


def _gather_beams(tree: Any, beam_idx: torch.Tensor, batch: int, beam: int):
    """Select beams: leaf (B*K, ...) -> rows ``beam_idx`` (B, K) within each
    sentence. All float leaves (the KV cache) go through one
    ``gather_rows`` call: the row-gather kernel on a GPU, ``index_select``
    on the CPU. Integer leaves are indexed (take_along_axis in JAX)."""
    src_rows = (torch.arange(batch, device=beam_idx.device)[:, None] * beam
                + beam_idx).reshape(-1)
    leaves, rebuild = _flatten(tree)
    floats = [i for i, x in enumerate(leaves) if x.is_floating_point()]
    out = list(leaves)
    if floats:
        for i, y in zip(floats, gather_rows([leaves[i] for i in floats],
                                            src_rows)):
            out[i] = y
    for i, x in enumerate(leaves):
        if not x.is_floating_point():
            out[i] = x.index_select(0, src_rows)
    return rebuild(out)


def ancestry_reorder(cache: Any, orig_beam: torch.Tensor, batch: int,
                     beam: int, t: int) -> Any:
    """Beam reorder for ancestry-mode caches: permute only the (B, K, L)
    ancestry table; the KV leaves stay slot-major and ancestor rows are
    selected inside attention (``MultiHeadAttention.attend_ancestry``).
    Afterwards the identity is written at position t+1, clamped into the
    table as ``dynamic_update_slice`` does (the last step's write lands on
    a slot that is never read)."""
    anc = cache["anc"]
    anc = anc.gather(1, orig_beam[:, :, None].expand(-1, -1, anc.shape[2]))
    col = min(t + 1, anc.shape[2] - 1)
    anc[:, :, col] = torch.arange(beam, device=anc.device, dtype=anc.dtype)
    new = dict(cache)
    new["anc"] = anc
    return new


def _banned_ngram_mask(seqs: torch.Tensor, t: int, n: int,
                       vocab: int) -> torch.Tensor:
    """(R, L) sequences -> (R, V) float mask, NEG_INF where the token would
    complete an n-gram already present (fairseq no_repeat_ngram)."""
    r, length = seqs.shape
    m = n - 1
    num_p = length - m
    start = min(max(t - m + 1, 0), length - m)  # dynamic_slice clamps
    cur = seqs[:, start:start + m]  # (R, m)
    # window p: gram seqs[:, p:p+m], next token seqs[:, p+m]
    grams = (seqs.unfold(1, m, 1)[:, :num_p] if m
             else seqs.new_zeros(r, num_p, 0))
    nexts = seqs[:, m:m + num_p]
    p_idx = torch.arange(num_p, device=seqs.device)
    valid = (p_idx + m <= t) & (t - m + 1 >= 0)
    match = (grams == cur[:, None, :]).all(-1) & valid[None, :]
    banned = torch.zeros(r, vocab, dtype=torch.uint8, device=seqs.device)
    banned.scatter_reduce_(1, nexts, match.to(torch.uint8), reduce="amax")
    return torch.where(banned > 0, NEG_INF, 0.0)


def _first_tensor(tree: Any) -> torch.Tensor:
    return next(x for x in _flatten(tree)[0] if isinstance(x, torch.Tensor))

def beam_search(
    step_fn: Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]],
    init_cache: Any,
    batch_size: int,
    max_len: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    vocab_size: int,
    gen_cfg: GenConfig = GenConfig(),
    prefix_tokens: Optional[torch.Tensor] = None,
    unk_id: Optional[int] = None,
    reorder_cache_fn: Optional[
        Callable[[Any, torch.Tensor, int, int, int], Any]] = None,
    seg_bounds: Optional[Tuple[int, ...]] = None,
    grow_cache_fn: Optional[Callable[[Any, int], Any]] = None,
) -> BeamOutput:
    """Run beam search (the JAX ``beam_search``, same arguments).

    ``step_fn(last_tokens (B*K, 1), position int, cache) -> (logits (B*K, V)
    or (B*K, 1, V), cache)``; the cache is already tiled to B*K rows.
    ``seg_bounds`` + ``grow_cache_fn``: segmented decode, the cache grown to
    ``bound + 1`` (capped at max_len + 1) between segments; bounds of
    ``n_steps - 1`` or more are dropped, and the remaining segments are
    skipped once every quota is full.
    """
    k = gen_cfg.beam_size
    lp = gen_cfg.len_penalty
    rows = batch_size * k
    n_steps = max_len + 1  # fairseq: range(max_len + 1), eos forced at last
    seq_len = n_steps + 1  # slot 0 is bos
    dev = _first_tensor(init_cache).device
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    alive_seq = torch.full((rows, seq_len), pad_id, **i64)
    alive_seq[:, 0] = bos_id
    alive_scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), **f32).repeat(
        batch_size, 1)
    fin_seq = torch.full((batch_size, k, seq_len), pad_id, **i64)
    fin_scores = torch.full((batch_size, k), NEG_INF, **f32)
    fin_lens = torch.zeros((batch_size, k), **i64)
    prefix_len = 0
    if prefix_tokens is not None:
        prefix_tokens = prefix_tokens.to(**i64)
        prefix_len = prefix_tokens.shape[1]
    vocab_ids = torch.arange(vocab_size, device=dev)[None, :]
    ranks = torch.arange(2 * k, device=dev)[None, :]
    slots = torch.arange(k, device=dev)[None, :]

    def norm(score: torch.Tensor, length: int) -> torch.Tensor:
        if not gen_cfg.normalize_scores:
            return score
        # torch.full, not torch.tensor: no host-to-device copy, no sync
        return score / torch.full((), float(length), **f32) ** lp

    def quota_full() -> bool:  # the step's one host sync
        return bool((fin_scores > NEG_INF / 2).all())

    bounds: Tuple[int, ...] = (n_steps,)
    if seg_bounds is not None and grow_cache_fn is not None:
        if not all(int(b) >= 1 for b in seg_bounds):
            raise ValueError(f"seg_bounds must be >= 1, got {seg_bounds}")
        inner = sorted({int(b) for b in seg_bounds if int(b) < n_steps - 1})
        bounds = tuple(inner) + (n_steps,)

    cache = init_cache
    t = 0
    for i, bound in enumerate(bounds):
        while t < bound and not quota_full():
            logits, cache = step_fn(alive_seq[:, t:t + 1], t, cache)
            logits = logits.reshape(rows, vocab_size).float()
            if gen_cfg.temperature != 1.0:
                logits = logits / gen_cfg.temperature
            lprobs = torch.log_softmax(logits, dim=-1)
            lprobs[:, pad_id] = NEG_INF
            # a sentence with k finalized hypotheses is done
            batch_done = (fin_scores > NEG_INF / 2).all(1)
            lprobs = torch.where(batch_done.repeat_interleave(k)[:, None],
                                 NEG_INF, lprobs)
            if unk_id is not None and gen_cfg.unk_penalty != 0.0:
                lprobs[:, unk_id] += -gen_cfg.unk_penalty
            if gen_cfg.min_len > 0 and t < gen_cfg.min_len:
                lprobs[:, eos_id] = NEG_INF
            if gen_cfg.no_repeat_ngram_size > 0:
                lprobs = lprobs + _banned_ngram_mask(
                    alive_seq, t, gen_cfg.no_repeat_ngram_size, vocab_size)
            if t < prefix_len:
                # force the prefix token (seq_gen.py:546-573)
                ptok = prefix_tokens[:, min(t, prefix_len - 1)]
                ptok_rows = ptok.repeat_interleave(k)[:, None]
                lprobs = torch.where(vocab_ids == ptok_rows, lprobs, NEG_INF)
            if t >= n_steps - 1:  # final step: only eos (seq_gen.py:302-304)
                lprobs = torch.where(vocab_ids == eos_id, lprobs, NEG_INF)

            cand = (alive_scores.reshape(rows, 1) + lprobs).reshape(
                batch_size, k * vocab_size)
            # top 2K candidates so EOS picks cannot starve the alive set
            top_scores, top_idx = top_k(cand, 2 * k)
            beam_idx = top_idx // vocab_size  # (B, 2K)
            tok_idx = top_idx % vocab_size
            grown = alive_seq.view(batch_size, k, seq_len).gather(
                1, beam_idx[:, :, None].expand(-1, -1, seq_len))
            grown[:, :, t + 1] = tok_idx
            is_eos = tok_idx == eos_id

            # ---- finished update: fairseq appends EOS hypotheses ranked in
            # the top beam_size until the quota is full, never evicting
            eos_valid = is_eos & (ranks < k) & (top_scores > NEG_INF / 2)
            eos_scores = torch.where(eos_valid, norm(top_scores, t + 1),
                                     NEG_INF)
            all_fin_scores = torch.cat([fin_scores, eos_scores], 1)
            all_fin_seq = torch.cat([fin_seq, grown], 1)
            all_fin_lens = torch.cat(
                [fin_lens, torch.full(eos_scores.shape, t + 1, **i64)], 1)
            big = 10 * k
            exist_pri = torch.where(fin_scores > NEG_INF / 2, slots,
                                    big + slots)
            cand_pri = torch.where(eos_valid, k + ranks, 2 * big + ranks)
            _, fin_sel = top_k(-torch.cat([exist_pri, cand_pri], 1), k)
            fin_scores = all_fin_scores.gather(1, fin_sel)
            fin_seq = all_fin_seq.gather(
                1, fin_sel[:, :, None].expand(-1, -1, seq_len))
            fin_lens = all_fin_lens.gather(1, fin_sel)

            # ---- alive update
            alive_cand = torch.where(is_eos, NEG_INF, top_scores)
            alive_scores, alive_sel = top_k(alive_cand, k)
            alive_seq = grown.gather(
                1, alive_sel[:, :, None].expand(-1, -1, seq_len)
            ).reshape(rows, seq_len)
            # cache rows follow their beams; at k == 1 the reorder is the
            # identity and is skipped
            if k > 1:
                orig_beam = beam_idx.gather(1, alive_sel)
                if reorder_cache_fn is not None:
                    cache = reorder_cache_fn(cache, orig_beam, batch_size, k, t)
                else:
                    cache = _gather_beams(cache, orig_beam, batch_size, k)
            t += 1
        if i + 1 < len(bounds):
            if quota_full():
                break  # the remaining segments would run no step
            cache = grow_cache_fn(cache, min(bounds[i + 1] + 1, n_steps))

    # Degenerate fallback only (e.g. min_len >= the step budget): surface
    # still-alive beams; when the quota is full they never displace a
    # finalized hypothesis.
    alive_norm = norm(alive_scores, max(t, 1))
    full = (fin_scores > NEG_INF / 2).all(1, keepdim=True)
    alive_norm = torch.where(full, NEG_INF, alive_norm)
    all_scores = torch.cat([fin_scores, alive_norm], 1)
    all_seq = torch.cat([fin_seq, alive_seq.view(batch_size, k, seq_len)], 1)
    all_lens = torch.cat([fin_lens, torch.full((batch_size, k), t, **i64)], 1)
    final_scores, sel = top_k(all_scores, k)
    final_seq = all_seq.gather(1, sel[:, :, None].expand(-1, -1, seq_len))
    final_lens = all_lens.gather(1, sel)
    return BeamOutput(final_seq[:, :, 1:], final_scores, final_lens, t)
