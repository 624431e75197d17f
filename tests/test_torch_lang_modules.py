"""The two library modules of the port that no model builds:
``models/lang_utils.py:LSTMEncoder`` and ``models/rel_transformer.py:
RelTransformer``, against the JAX package's on the CPU in float32, with the
JAX modules' own initial values carried over by ``flax_to_state_dict``
(outputs within 1e-5 of their scale); their dropout in training mode from
an explicit generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.models.lang_utils import LSTMEncoder as JLSTM
from vidsitu_tpu.models.rel_transformer import RelTransformer as JRel
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from vidsitu_tpu_torch.models import common
from vidsitu_tpu_torch.models.lang_utils import LSTMEncoder
from vidsitu_tpu_torch.models.rel_transformer import RelTransformer

torch.set_num_threads(1)

TOL = 1e-5
VOCAB, PAD = 30, 0


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0))


def _tokens(left_pad: bool):
    """Rows of lengths 6, 3, 1 and 0 (all pad) out of 6, padded on the
    right, or on the left (the fairseq convention)."""
    rng = np.random.default_rng(0)
    toks = np.zeros((4, 6), np.int64)
    for r, n in enumerate((6, 3, 1, 0)):
        body = rng.integers(1, VOCAB, n)
        if left_pad:
            toks[r, 6 - n:] = body
        else:
            toks[r, :n] = body
    return toks


LSTM_CASES = {
    "uni_1": dict(num_layers=1, bidirectional=False),
    "bi_1": dict(num_layers=1, bidirectional=True),
    "bi_2": dict(num_layers=2, bidirectional=True),
    "uni_3": dict(num_layers=3, bidirectional=False),
}


@pytest.mark.parametrize("left_pad", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_encoder_matches_jax(case, left_pad):
    kw = dict(vocab_size=VOCAB, embed_dim=8, hidden_dim=6, pad_id=PAD,
              **LSTM_CASES[case])
    toks = _tokens(left_pad)
    jm = JLSTM(**kw)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(toks))
    want = jm.apply(variables, jnp.asarray(toks))
    pm = LSTMEncoder(**kw)
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                       variables)),
                       strict=True)
    pm.eval()
    got = pm(torch.from_numpy(toks))
    assert got["outputs"].shape == want["outputs"].shape
    _close(got["outputs"], want["outputs"])
    _close(got["final"], want["final"])
    assert not got["outputs"][3].any()  # an all-pad row stays zero
    # explicit lengths shorter than the tokens cut the rows there
    lengths = np.array([4, 2, 1, 0])
    want = jm.apply(variables, jnp.asarray(toks), jnp.asarray(lengths))
    got = pm(torch.from_numpy(toks), torch.from_numpy(lengths))
    _close(got["outputs"], want["outputs"])
    _close(got["final"], want["final"])


def test_lstm_dropout_draws_from_the_generator():
    """In train(): dropout on the embeddings, between layers and on the
    outputs, drawn from the generator; ``final`` from the states before the
    output dropout; eval() and rates 0 are the plain forward."""
    toks = torch.from_numpy(_tokens(False))
    pm = common.init_like_flax(LSTMEncoder(VOCAB, 8, 6, num_layers=2,
                                           bidirectional=True), 3)
    pm.eval()
    plain = pm(toks)
    pm.train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad(), common.dropout_generator(gen):
        state = gen.get_state()
        a = pm(toks)
        gen.set_state(state)
        b = pm(toks)
    assert torch.equal(a["outputs"], b["outputs"])
    assert not torch.allclose(a["outputs"], plain["outputs"])
    pm.dropout_in = pm.dropout_out = 0.0
    with torch.no_grad():
        out = pm(toks)
    assert torch.equal(out["outputs"], plain["outputs"])
    # one layer, only the output dropout: final equals the undropped states
    one = common.init_like_flax(LSTMEncoder(VOCAB, 8, 6, bidirectional=True,
                                            dropout_in=0.0, dropout_out=0.5),
                                3)
    one.eval()
    plain = one(toks)
    one.train()
    with torch.no_grad(), common.dropout_generator(gen):
        out = one(toks)
    assert torch.equal(out["final"], plain["final"])
    assert not torch.equal(out["outputs"], plain["outputs"])
    # recurrent kernels orthogonal (flax's recurrent_kernel_init)
    w = pm.fwd_l0.hi.weight
    assert torch.allclose(w @ w.t(), torch.eye(6), atol=1e-5)


REL_CASES = {
    "plain": dict(causal=False, pe=False, mask=False),
    "causal": dict(causal=True, pe=False, mask=False),
    "pe": dict(causal=False, pe=True, mask=False),
    "causal_pe_mask": dict(causal=True, pe=True, mask=True),
}


@pytest.mark.parametrize("case", list(REL_CASES))
def test_rel_transformer_matches_jax(case):
    c = REL_CASES[case]
    rng = np.random.default_rng(2)
    b, n, d, h = 2, 5, 16, 4
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    pe = (rng.standard_normal((b, n, n, h)).astype(np.float32)
          if c["pe"] else None)
    mask = (np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0]], np.float32)[..., None]
            if c["mask"] else None)
    kw = dict(d_model=d, d_hidden=32, n_layers=3, n_heads=h, dropout=0.1,
              causal=c["causal"])
    jm = JRel(**kw)
    jargs = [jnp.asarray(x), None if pe is None else jnp.asarray(pe),
             None if mask is None else jnp.asarray(mask)]
    variables = jm.init(jax.random.PRNGKey(0), *jargs)
    want = jm.apply(variables, *jargs, all_outputs=True)
    pm = RelTransformer(**kw)
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                       variables)),
                       strict=True)
    pm.eval()
    targs = [torch.from_numpy(x), None if pe is None else torch.from_numpy(pe),
             None if mask is None else torch.from_numpy(mask)]
    got = pm(*targs, all_outputs=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w)
    _close(pm(*targs), want[-1])
    # the flax tree comes back from the port's state_dict
    back = state_dict_to_flax(pm.state_dict(), pm)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, variables))


def test_rel_transformer_dropout_in_train_mode():
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0))
    pm = common.init_like_flax(RelTransformer(16, 32, 2, 4, dropout=0.2), 1)
    pm.eval()
    plain = pm(x)
    pm.train()
    with pytest.raises(RuntimeError, match="dropout_generator"):
        pm(x)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad(), common.dropout_generator(gen):
        state = gen.get_state()
        a = pm(x)
        gen.set_state(state)
        assert torch.equal(a, pm(x))
    assert not torch.allclose(a, plain)
