"""Port beam search (vidsitu_tpu_torch/gen/beam.py) and the beam-cache row
gather (vidsitu_tpu_torch/ops/beam_gather.py) against the JAX package's.

``beam_search`` runs on both sides with one history-dependent numpy step
table (the logits are a row of the table picked by a hash of the tokens so
far, which the cache carries, so a wrong cache reorder changes the tokens).
Sequences, scores and lengths must be equal exactly. The table's logits are
spread so that log-softmax is exact in float32 in any summation order (all
but the largest exponentials underflow to 0), which makes exact scores a
fair demand of two frameworks.

The CUDA kernel runs only on a GPU: its test is marked ``cuda`` and skips
here; chip_smoke.py holds it against the plain version at the decode's
real cache shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.gen import beam as jbeam
from vidsitu_tpu_torch.gen import beam as pbeam
from vidsitu_tpu_torch.ops import beam_gather as bg

torch.set_num_threads(1)

V, PAD, EOS, BOS, UNK = 24, 0, 2, 2, 3
NTAB = 61


def step_table(seed, eos_frac=0.0):
    """(NTAB, V) logits and 256 hash multipliers. Each row has one largest
    entry, 0, and the others lie below -120, so exp() of every other entry
    is 0 in float32 and log-softmax is exact. In about ``eos_frac`` of the
    rows the largest entry is EOS."""
    rng = np.random.default_rng(seed)
    tbl = -120.0 - 30.0 * rng.random((NTAB, V))
    top = rng.integers(0, V, NTAB)
    top[rng.random(NTAB) < eos_frac] = EOS
    tbl[np.arange(NTAB), top] = 0.0
    return tbl.astype(np.float32), rng.integers(1, 1000, 256)


def run_jax(tbl, mults, bsz, gen_cfg, max_len, prefix, seg):
    tbl_j = jnp.asarray(tbl)
    mults_j = jnp.asarray(mults[: max_len + 2], jnp.int32)
    rows = bsz * gen_cfg.beam_size
    length = (seg[0] + 2) if seg else (max_len + 2)
    cache = {"hist": jnp.zeros((rows, length), jnp.int32),
             "fhist": jnp.zeros((rows, length), jnp.float32)}

    def step_fn(last_tok, t, cache):
        f = jax.lax.dynamic_update_slice(
            cache["fhist"], last_tok.astype(jnp.float32), (0, t))
        h = jax.lax.dynamic_update_slice(
            cache["hist"], last_tok.astype(jnp.int32), (0, t))
        idx = (f.astype(jnp.int32) * mults_j[None, : f.shape[1]]).sum(1)
        return tbl_j[(idx + h.sum(1)) % NTAB], {"hist": h, "fhist": f}

    def grow(cache, new_len):
        return {k: jnp.concatenate(
            [v, jnp.zeros((v.shape[0], new_len + 1 - v.shape[1]), v.dtype)], 1)
            for k, v in cache.items()}

    out = jax.jit(lambda c: jbeam.beam_search(
        step_fn, c, batch_size=bsz, max_len=max_len, bos_id=BOS, eos_id=EOS,
        pad_id=PAD, vocab_size=V, gen_cfg=gen_cfg,
        prefix_tokens=None if prefix is None else jnp.asarray(prefix),
        unk_id=UNK, seg_bounds=seg or None, grow_cache_fn=grow if seg else None,
    ))(cache)
    return [np.asarray(x) for x in out]


def run_port(tbl, mults, bsz, gen_cfg, max_len, prefix, seg):
    tbl_t = torch.from_numpy(tbl)
    mults_t = torch.from_numpy(mults[: max_len + 2])
    rows = bsz * gen_cfg.beam_size
    length = (seg[0] + 2) if seg else (max_len + 2)
    cache = {"hist": torch.zeros(rows, length, dtype=torch.int64),
             "fhist": torch.zeros(rows, length)}
    steps = []

    def step_fn(last_tok, t, cache):
        f, h = cache["fhist"].clone(), cache["hist"].clone()
        f[:, t] = last_tok[:, 0].float()
        h[:, t] = last_tok[:, 0]
        idx = (f.long() * mults_t[None, : f.shape[1]]).sum(1)
        steps.append(t)
        return tbl_t[(idx + h.sum(1)) % NTAB], {"hist": h, "fhist": f}

    def grow(cache, new_len):
        return {k: torch.cat(
            [v, v.new_zeros(v.shape[0], new_len + 1 - v.shape[1])], 1)
            for k, v in cache.items()}

    out = pbeam.beam_search(
        step_fn, cache, batch_size=bsz, max_len=max_len, bos_id=BOS,
        eos_id=EOS, pad_id=PAD, vocab_size=V, gen_cfg=gen_cfg,
        prefix_tokens=None if prefix is None else torch.from_numpy(prefix),
        unk_id=UNK, seg_bounds=seg or None, grow_cache_fn=grow if seg else None)
    assert out.steps == len(steps)
    return [out.seqs.numpy(), out.scores.numpy(), out.lengths.numpy()]


# (options, max_len, with prefix, segment bounds)
SEARCHES = {
    "plain": ({}, 12, False, ()),
    "prefix": ({}, 12, True, ()),
    "min_len": ({"min_len": 6}, 12, False, ()),
    "ngram2": ({"no_repeat_ngram_size": 2}, 14, True, ()),
    "len_penalty": ({"len_penalty": 2.0, "unk_penalty": 0.5}, 12, False, ()),
    "unnormalized": ({"normalize_scores": False, "len_penalty": 0.5}, 10,
                     False, ()),
    "segments": ({}, 20, True, (4, 8, 16)),
}


@pytest.mark.parametrize("beam", [1, 3, 5])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_beam_search_matches_jax(name, beam):
    opts, max_len, with_prefix, seg = SEARCHES[name]
    tbl, mults = step_table(100 + beam, eos_frac=0.2)
    gen_cfg = jbeam.GenConfig(beam_size=beam, max_len_b=max_len, **opts)
    bsz = 3
    prefix = None
    if with_prefix:
        prefix = np.random.default_rng(beam).integers(4, V, (bsz, 2))
    ref = run_jax(tbl, mults, bsz, gen_cfg, max_len, prefix, seg)
    out = run_port(tbl, mults, bsz, pbeam.GenConfig(**gen_cfg.__dict__),
                   max_len, prefix, seg)
    for what, a, b in zip(("seqs", "scores", "lengths"), out, ref):
        np.testing.assert_array_equal(a, b, err_msg=what)
    if with_prefix:
        assert (out[0][:, :, :2] == prefix[:, None, :]).all()


def test_beam_search_real_logits_tokens_exact():
    """Unspread logits (standard normal): the tokens and lengths still agree
    exactly; the scores to float32 rounding of the log-softmax sums."""
    rng = np.random.default_rng(7)
    tbl = (3 * rng.standard_normal((NTAB, V))).astype(np.float32)
    mults = rng.integers(1, 1000, 256)
    gen_cfg = jbeam.GenConfig(beam_size=4, max_len_b=15)
    ref = run_jax(tbl, mults, 3, gen_cfg, 15, None, ())
    out = run_port(tbl, mults, 3, pbeam.GenConfig(**gen_cfg.__dict__), 15,
                   None, ())
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape,k", [((4, 40), 10), ((2, 3, 17), 6),
                                     ((5, 250), 10)])
def test_top_k_ties_match_lax(shape, k):
    """Many equal values (small integers, NEG_INF and 2*NEG_INF, as under
    prefix forcing and at the first step): values and indices equal
    ``lax.top_k``'s, which takes the lower index first."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-3, 3, shape).astype(np.float32)
    x[rng.random(shape) < 0.4] = -1e9
    x[rng.random(shape) < 0.2] = -2e9
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    pv, pi = pbeam.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def _tree(rng, rows):
    return {
        "layers": [{"self_k": rng.standard_normal((rows, 3, 7, 4))
                    .astype(np.float32),
                    "cross_v": rng.standard_normal((rows, 1, 2, 3))
                    .astype(np.float32)} for _ in range(2)],
        "anc": rng.integers(0, 5, (rows, 6)).astype(np.int32),
    }


def test_gather_beams_plain_matches_jax():
    rng = np.random.default_rng(0)
    batch, beam = 4, 3
    tree = _tree(rng, batch * beam)
    beam_idx = rng.integers(0, beam, (batch, beam))
    ref = jbeam._gather_beams(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(beam_idx), batch, beam)
    before = bg.LAUNCHES
    out = pbeam._gather_beams(pbeam.tree_map(torch.from_numpy, tree),
                              torch.from_numpy(beam_idx), batch, beam)
    assert bg.LAUNCHES == before  # the CPU takes the plain version
    np.testing.assert_array_equal(out["anc"].numpy(), np.asarray(ref["anc"]))
    for je, pe in zip(ref["layers"], out["layers"]):
        for name in je:
            np.testing.assert_array_equal(pe[name].numpy(),
                                          np.asarray(je[name]))


def test_ancestry_reorder_matches_jax():
    rng = np.random.default_rng(1)
    batch, beam, length = 3, 4, 6
    anc = rng.integers(0, beam, (batch, beam, length))
    orig = rng.integers(0, beam, (batch, beam))
    for t in (0, 3, length - 1):  # t+1 == length clamps onto the last column
        ref = jbeam.ancestry_reorder({"anc": jnp.asarray(anc, jnp.int32)},
                                     jnp.asarray(orig, jnp.int32), batch,
                                     beam, jnp.asarray(t))["anc"]
        out = pbeam.ancestry_reorder({"anc": torch.from_numpy(anc)},
                                     torch.from_numpy(orig), batch, beam,
                                     t)["anc"]
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_banned_ngram_mask_matches_jax(n):
    rng = np.random.default_rng(n)
    seqs = rng.integers(0, 4, (6, 12))
    for t in range(0, 11, 2):
        ref = jbeam._banned_ngram_mask(jnp.asarray(seqs, jnp.int32), t, n, 9)
        out = pbeam._banned_ngram_mask(torch.from_numpy(seqs), t, n, 9)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_tile_for_beams_is_repeat_interleave():
    x = np.arange(6).reshape(3, 2)
    out = pbeam.tile_for_beams({"a": torch.from_numpy(x)}, 2)["a"].numpy()
    np.testing.assert_array_equal(out, np.asarray(jbeam.tile_for_beams(
        jnp.asarray(x), 2)))


def test_kernel_wrapper_raises_on_cpu_tensors():
    x = torch.zeros(4, 8)
    idx = torch.tensor([1, 0, 0, 3])
    with pytest.raises(ValueError, match="not CUDA"):
        bg.beam_gather_rows([x], idx)
    with pytest.raises(ValueError, match="no leaves"):
        bg.beam_gather_rows([], idx)
    before = bg.LAUNCHES
    out = bg.gather_rows([x, x[:, :3].contiguous()], idx)
    assert bg.LAUNCHES == before and [o.shape[1] for o in out] == [8, 3]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU (chip_smoke.py runs it)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_kernel_matches_reference_on_gpu(cuda_device, dtype, index_dtype):
    """Bit-identical to ``index_select`` on repeated indices, for rows of
    16-byte multiples, odd widths (scalar tails) and an offset view
    (misaligned base pointers), all in one launch."""
    rng = np.random.default_rng(4)
    rows = 40
    idx = torch.from_numpy(rng.integers(0, rows, rows)).to(cuda_device,
                                                          index_dtype)
    base = torch.randn(rows * 131 + 1, device=cuda_device).to(dtype)
    leaves = [
        torch.randn(rows, 17, 8, 16, device=cuda_device).to(dtype),
        torch.randn(rows, 1, 8, 16, device=cuda_device).to(dtype),
        torch.randn(rows, 3, device=cuda_device).to(dtype),
        base[1:].view(rows, 131),  # base pointer off the 16-byte grid
    ]
    before = bg.LAUNCHES
    out = bg.beam_gather_rows(leaves, idx)
    ref = bg.beam_gather_rows_reference(leaves, idx.long())
    torch.cuda.synchronize()
    assert bg.LAUNCHES == before + 1
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
