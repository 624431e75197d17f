"""Port SRL models (vidsitu_tpu_torch/models/{transformer,srl_models}.py)
against the JAX package's on the CPU, in float32, on one numpy-seeded
flax-layout weight tree given to both (the port through
``convert.from_flax.flax_to_state_dict``).

Tolerance: atol 1e-5 on logits and K/V. Both sides compute in float32
(the JAX tests force matmul precision to 'highest'); the sums run in other
orders, which moves values by a few float32 ulps at these magnitudes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu.models import common as jcommon
from vidsitu_tpu.models import selector as jsel
from vidsitu_tpu.utils.config import get_cfg_with_overrides
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
)
from vidsitu_tpu_torch.models import common as pcommon
from vidsitu_tpu_torch.models import selector as psel

torch.set_num_threads(1)

ATOL = 1e-5

TINY = {
    "tx_dec.decoder_embed_dim": 64,
    "tx_dec.decoder_ffn_embed_dim": 128,
    "tx_dec.decoder_layers": 2,
    "tx_dec.decoder_attention_heads": 4,
    "tx_dec.encoder_embed_dim": 64,
    "tx_dec.encoder_ffn_embed_dim": 128,
    "tx_dec.encoder_layers": 2,
    "tx_dec.encoder_attention_heads": 4,
    "gpt2_mdl.d_model": 64,
    "gpt2_mdl.n_layers": 2,
    "gpt2_mdl.n_heads": 4,
    "gpt2_mdl.max_pos": 128,
}


def srl_cfg(paths, root, mdl_name, **kw):
    return get_cfg_with_overrides("torch_srl", **{
        **paths, **TINY,
        "task_type": "vb_arg",
        "mdl.mdl_name": mdl_name,
        "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
        "train.dtype": "float32",
        "misc.tmp_path": str(root / "tmp"),
        **kw,
    })


def build_pair(cfg, comm, seed=0):
    """(JAX model, port model, flax-layout numpy tree), the port loaded
    with the tree."""
    pmodel = psel.build_model(cfg, comm)
    tree = seeded_variables(pmodel, seed)
    pmodel.load_state_dict(flax_to_state_dict(tree), strict=True)
    pmodel.eval()
    return jsel.build_model(cfg, comm), pmodel, tree


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srl")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=2,
                               seed=3)
    cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg")
    batch = next(iter(get_data(cfg).valid_dl))
    return paths, root, build_comm(cfg), batch


def _jax_logits(module, inp):
    toks = inp["seq_out_by_ev"][:, :, 0, :]
    enc_out, enc_mask = module.encode(inp, True)
    return module.decoder(toks.reshape(-1, toks.shape[-1]), enc_out=enc_out,
                          enc_pad_mask=enc_mask)


CASES = [("tx_only", "old"), ("new_gpt2_only", "old"), ("txed_only", "old"),
         ("sfpret_txed_vbarg", "old"), ("sfpret_txe_txd_vbarg", "old"),
         ("sfpret_txe_txd_vbarg", "new"), ("sfpret_txe_txd_vbarg", "new_conc")]


@pytest.mark.parametrize("mdl_name,enc_type", CASES,
                         ids=[f"{m}-{e}" for m, e in CASES])
def test_teacher_forced_logits_and_loss(env, mdl_name, enc_type):
    paths, root, comm, batch = env
    cfg = srl_cfg(paths, root, mdl_name, **{"mdl.tx_enc_type": enc_type})
    jmodel, pmodel, tree = build_pair(cfg, comm, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jmodel.apply(tree, jb, method=_jax_logits))
    ref_loss = float(jmodel.apply(tree, jb)["loss"])
    with torch.no_grad():
        out = pmodel.teacher_forced_logits(to_torch(batch)).numpy()
        loss = float(pmodel(to_torch(batch))["loss"])
    assert out.shape == ref.shape == (batch["seq_out_by_ev"].shape[0] * 5, 60,
                                      len(comm.gpt2_hf_tok))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(loss, ref_loss, atol=ATOL, rtol=0)


def _seeded_cache(rng, rows, n_layers, heads, length, dh, cross_len):
    layers = []
    for _ in range(n_layers):
        e = {n: rng.standard_normal((rows, length, heads, dh)).astype(np.float32)
             for n in ("self_k", "self_v")}
        if cross_len:
            e.update({n: rng.standard_normal((rows, cross_len, heads, dh))
                      .astype(np.float32) for n in ("cross_k", "cross_v")})
        layers.append(e)
    return layers


def _head_major(a):  # JAX (R, L, H, Dh) -> port (R, H, L, Dh)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("mdl_name", ["sfpret_txe_txd_vbarg", "new_gpt2_only",
                                      "txed_only"])
@pytest.mark.parametrize("mode", ["reorder", "ancestry"])
def test_decode_step_logits_and_cache(env, mdl_name, mode):
    """One incremental step on a seeded, partly filled cache: logits and the
    written K/V agree; in ancestry mode ``anc`` names random slots."""
    from vidsitu_tpu.models.srl_models import SRLModel as JSRL

    paths, root, comm, _ = env
    cfg = srl_cfg(paths, root, mdl_name)
    jmodel, pmodel, tree = build_pair(cfg, comm, seed=2)
    rng = np.random.default_rng(5)
    b, k, length, pos = 3, 4, 9, 5
    rows = b * k
    heads, d = 4, 64
    cross_len = 0 if mdl_name == "new_gpt2_only" else (
        5 if mdl_name == "txed_only" else 1)
    layers = _seeded_cache(rng, rows, 2, heads, length, d // heads, cross_len)
    token = rng.integers(3, len(comm.gpt2_hf_tok), (rows, 1))
    enc_pad = None
    if mdl_name == "txed_only":
        enc_pad = (rng.random((rows, cross_len)) > 0.3).astype(np.int32)
        enc_pad[:, 0] = 1
    anc = rng.integers(0, k, (b, k, length)) if mode == "ancestry" else None

    jcache = {"layers": [{n: jnp.asarray(v) for n, v in e.items()}
                         for e in layers]}
    if anc is not None:
        jcache["anc"] = jnp.asarray(anc, jnp.int32)
    jmask = (jcommon.make_padding_mask(jnp.asarray(enc_pad))
             if enc_pad is not None else None)
    jlogits, jnew = jmodel.apply(tree, jnp.asarray(token, jnp.int32), pos,
                                 jcache, jmask, method=JSRL.gen_decode_step)

    pcache = {"layers": [{n: _head_major(v) for n, v in e.items()}
                         for e in layers]}
    if anc is not None:
        pcache["anc"] = torch.from_numpy(anc)
    pmask = (pcommon.make_padding_mask(torch.from_numpy(enc_pad))
             if enc_pad is not None else None)
    with torch.no_grad():
        plogits, pnew = pmodel.gen_decode_step(torch.from_numpy(token), pos,
                                               pcache, pmask)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    for je, pe in zip(jnew["layers"], pnew["layers"]):
        assert set(je) == set(pe)
        for n in je:
            np.testing.assert_allclose(
                pe[n].numpy().transpose(0, 2, 1, 3), np.asarray(je[n]),
                atol=ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("mdl_name", ["tx_only", "new_gpt2_only", "txed_only",
                                      "sfpret_txed_vbarg",
                                      "sfpret_txe_txd_vbarg"])
def test_converter_round_trip(env, mdl_name):
    """The port's seeded tree has exactly the JAX model's parameter paths,
    shapes and layouts (flax init), and loads strictly back into the port."""
    paths, root, comm, batch = env
    cfg = srl_cfg(paths, root, mdl_name,
                  **({"mdl.tx_enc_type": "new_conc"}
                     if mdl_name == "sfpret_txe_txd_vbarg" else {}))
    jmodel, pmodel, tree = build_pair(cfg, comm)
    init = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()}))
    flat_j = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]}
    flat_p = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat_p == flat_j
    sd = flax_to_state_dict(tree)
    fresh = psel.build_model(cfg, comm)
    fresh.load_state_dict(sd, strict=True)
    for name, t in fresh.state_dict().items():
        torch.testing.assert_close(t, pmodel.state_dict()[name], rtol=0, atol=0)


def test_sinusoidal_and_masks_match_jax():
    np.testing.assert_array_equal(pcommon.sinusoidal_positions(300, 64),
                                  jcommon.sinusoidal_positions(300, 64))
    np.testing.assert_array_equal(pcommon.sinusoidal_positions(7, 9),
                                  jcommon.sinusoidal_positions(7, 9))
    np.testing.assert_array_equal(pcommon.make_causal_mask(6).numpy(),
                                  np.asarray(jcommon.make_causal_mask(6)))
    pad = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        pcommon.make_padding_mask(torch.from_numpy(pad)).numpy(),
        np.asarray(jcommon.make_padding_mask(jnp.asarray(pad))))
    assert pcommon.make_padding_mask(None) is None
