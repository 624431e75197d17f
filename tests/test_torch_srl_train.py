"""SRL (vb_arg) training in the port (vidsitu_tpu_torch) against the JAX
package, on the CPU at tiny widths:

  * one Adam(0.9, 0.99) step of every SRL model and of the three
    ``tx_enc_type``s of ``sfpret_txe_txd_vbarg`` in float64 with every
    dropout rate 0 (the JAX side ``deterministic=True``): the loss within
    1e-5 of itself, each gradient within 1e-4 of its leaf's scale, the
    updated parameters (the shared helpers below also serve
    tests/test_torch_evrel.py);
  * the dropout sites: JAX's ``_dropout`` and the port's
    ``models.common.dropout`` replaced by the same deterministic stand-in,
    ``x * (1 - rate)`` in training mode, give the same float32 train-mode
    logits (1e-4 of their scale) with distinct rates at the three kinds of
    site;
  * the port's dropout itself: the keep share, the 1 / keep scale, identity
    in ``eval()``, the same masks from the same generator state, and no
    draw from the global random state;
  * ``python -m vidsitu_tpu_torch.main --task_type=vb_arg``: a 2-epoch fit,
    the bitwise resume with dropout on, and ``--only_val`` on the fitted
    weights giving the JAX package's ``valid_0.pkl`` on the same weights
    (through ``state_dict_to_flax``);
  * the ``gpt2_mdl_path`` branch of the pretrained policy against the JAX
    package's, on a seeded HF-layout GPT-2 state dict.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_transformer import TINY, srl_cfg, to_torch
from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu.evaluation.evaluators import EvalB_Gen as JEvalB_Gen
from vidsitu_tpu.models import roberta as jroberta
from vidsitu_tpu.models import selector as jsel
from vidsitu_tpu.models import transformer as jtx
from vidsitu_tpu.train.pretrained import (
    load_pretrained_variables as jax_load_pretrained,
)
from vidsitu_tpu_torch import main as pmain
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
    state_dict_to_flax,
)
from vidsitu_tpu_torch.models import common as pcommon
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models.srl_models import SRLModel
from vidsitu_tpu_torch.train.learner import Learner
from vidsitu_tpu_torch.train.pretrained import load_pretrained_variables

torch.set_num_threads(1)

LR = 1e-3
GRAD_TOL, LOSS_TOL, UPDATE_TOL, LOGIT_TOL = 1e-4, 1e-5, 1e-6, 1e-4


# -- shared with tests/test_torch_evrel.py -----------------------------------
def jax_adam_step(jmodel, tree, batch):
    """float64 (``jax_enable_x64`` for this call only): the loss, gradients
    and Adam-updated params of one step of ``jmodel`` (built with float64
    dtypes) on ``batch``, with ``deterministic=True``."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              tree["params"])
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            return jmodel.apply({"params": p}, jb, deterministic=True)["loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        opt = optax.adam(LR, b1=0.9, b2=0.99)
        upd, _ = opt.update(grads, opt.init(params), params)
        new = optax.apply_updates(params, upd)
        return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
                "params": jax.tree.map(np.asarray, new)}
    finally:
        jax.config.update("jax_enable_x64", prev)


def port_adam_step(model, cfg, batch):
    """The port's ``Learner.train_step`` (train mode, dropout rates 0) on a
    float64 model: (loss, gradients by name, the updated model)."""
    learner = Learner("t", cfg, model, None, None, "cpu")
    learner.prepare_optimizer(LR)
    grads = {}
    step = learner.optimizer.step

    def keep_grads_then_step():
        grads.update({n: (torch.zeros_like(p) if p.grad is None
                          else p.grad.clone())
                      for n, p in model.named_parameters()})
        step()

    learner.optimizer.step = keep_grads_then_step
    loss = float(learner.train_step(to_torch(batch)))
    return loss, grads, model


def check_step(ref, loss, grads, model):
    """Loss (LOSS_TOL of itself), every gradient (GRAD_TOL of the larger of
    its leaf's scale and 1e-3 of the model's largest gradient: a leaf whose
    gradient is zero in exact arithmetic, such as a key bias, holds
    rounding noise only) and every updated parameter: within UPDATE_TOL
    where the gradient's sign is determined, within 2 lr where |g_ref| lies
    within the gradient tolerance (Adam's first update is about lr *
    sign(g))."""
    assert abs(loss - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    want_g = flax_to_state_dict({"params": ref["grads"]})
    want_p = flax_to_state_dict({"params": ref["params"]})
    assert set(want_g) == set(grads)
    floor = 1e-3 * max(float(v.abs().max()) for v in want_g.values())
    got_p = model.state_dict()
    for n, g in grads.items():
        w = want_g[n].double().numpy()
        atol = GRAD_TOL * max(float(np.abs(w).max()), floor)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=n)
        undetermined = np.abs(w) <= atol
        diff = np.abs(got_p[n].numpy() - want_p[n].double().numpy())
        assert diff[~undetermined].max(initial=0) <= UPDATE_TOL, n
        assert diff[undetermined].max(initial=0) <= 2 * LR + UPDATE_TOL, n


def standin_jax(x, rate, deterministic, rng_fn):
    """The stand-in for the JAX package's ``_dropout``: a deterministic
    scale by the keep share at every active site."""
    if rate <= 0.0 or deterministic:
        return x
    return x * (1.0 - rate)


def standin_port(x, rate, training):
    if rate <= 0.0 or not training:
        return x
    return x * (1.0 - rate)


@pytest.fixture
def standin_dropout(monkeypatch):
    monkeypatch.setattr(jtx, "_dropout", standin_jax)
    monkeypatch.setattr(jroberta, "_dropout", standin_jax)
    monkeypatch.setattr(pcommon, "dropout", standin_port)


def assert_close_to_scale(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


# -- fixtures ------------------------------------------------------------------
@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srl_train")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=1,
                               seed=7)
    cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg")
    return paths, root, build_comm(cfg), next(iter(get_data(cfg).train_dl))


CASES = [("tx_only", "old"), ("new_gpt2_only", "old"), ("txed_only", "old"),
         ("sfpret_txed_vbarg", "old"), ("sfpret_txe_txd_vbarg", "old"),
         ("sfpret_txe_txd_vbarg", "new"), ("sfpret_txe_txd_vbarg", "new_conc")]
IDS = [f"{m}-{e}" for m, e in CASES]


def _f64_pair(cfg, comm, seed):
    """(JAX model with float64 dtypes, port model in float64 with every
    dropout rate 0, the seeded tree both hold)."""
    pm = psel.build_model(cfg, comm)
    tree = seeded_variables(pm, seed)
    jm = jsel.build_model(cfg, comm)
    f64 = dict(dtype=jnp.float64, param_dtype=jnp.float64)
    jm = jm.clone(dec_cfg=dataclasses.replace(jm.dec_cfg, **f64),
                  enc_cfg=dataclasses.replace(jm.enc_cfg, **f64))
    no_drop = dict(dtype=torch.float64, dropout=0.0, attn_dropout=0.0,
                   act_dropout=0.0)
    pm = SRLModel(pm.mdl_name, dataclasses.replace(pm.dec_cfg, **no_drop),
                  dataclasses.replace(pm.enc_cfg, **no_drop), pm.tx_enc_type,
                  pm.feat_dim)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    return jm, pm.double(), tree


@pytest.mark.parametrize("mdl_name,enc_type", CASES, ids=IDS)
def test_adam_step_matches_jax_float64(env, tmp_path, mdl_name, enc_type):
    paths, root, comm, batch = env
    cfg = srl_cfg(paths, tmp_path, mdl_name,
                  **{"mdl.tx_enc_type": enc_type, "tx_dec.dropout": 0.0})
    jm, pm, tree = _f64_pair(cfg, comm, seed=3)
    ref = jax_adam_step(jm, tree, batch)
    loss, grads, model = port_adam_step(pm, cfg, batch)
    check_step(ref, loss, grads, model)
    # the step did something: the output layer moved by about lr
    moved = [n for n, g in grads.items() if g.abs().max() > 0]
    assert len(moved) > len(grads) // 2


@pytest.mark.parametrize("mdl_name,enc_type", CASES, ids=IDS)
def test_dropout_sites_match_jax(env, standin_dropout, mdl_name, enc_type):
    """Train-mode float32 logits with the same stand-in at every dropout
    site: attention probabilities (0.2), FFN activation (0.3), sub-block
    outputs and embeddings (0.1; GPT-2's own 0.1)."""
    from vidsitu_tpu.models.srl_models import SRLModel as JSRL

    paths, root, comm, batch = env
    cfg = srl_cfg(paths, root, mdl_name, **{
        "mdl.tx_enc_type": enc_type, "tx_dec.dropout": 0.1,
        "tx_dec.attention_dropout": 0.2, "tx_dec.activation_dropout": 0.3})
    pm = psel.build_model(cfg, comm)
    tree = seeded_variables(pm, 5)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    jm = jsel.build_model(cfg, comm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_logits(module, inp):
        toks = inp["seq_out_by_ev"][:, :, 0, :]
        enc_out, enc_mask = module.encode(inp, False)
        return module.decoder(toks.reshape(-1, toks.shape[-1]),
                              enc_out=enc_out, enc_pad_mask=enc_mask,
                              deterministic=False)

    want = np.asarray(jm.apply(tree, jb, method=jax_logits))
    want_eval = np.asarray(jm.apply(
        tree, jb, method=lambda m, i: JSRL.__call__(m, i, True)["loss"]))
    pm.train()
    with torch.no_grad():
        got = pm.teacher_forced_logits(to_torch(batch)).numpy()
        pm.eval()
        got_eval = float(pm(to_torch(batch))["loss"])
    assert_close_to_scale(got, want, LOGIT_TOL)
    np.testing.assert_allclose(got_eval, float(want_eval), rtol=1e-5)
    # the stand-in really acts: train mode differs from eval mode (little
    # for GPT-2, whose only site scales every sub-block alike before a
    # LayerNorm)
    with torch.no_grad():
        assert not np.array_equal(
            pm.teacher_forced_logits(to_torch(batch)).numpy(), got)


# -- the port's dropout -----------------------------------------------------
def test_dropout_statistics_and_generator():
    x = torch.ones(1_000_000)
    gen = torch.Generator().manual_seed(0)
    with pcommon.dropout_generator(gen):
        y = pcommon.dropout(x, 0.3, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    # identity in eval(), at rate 0, and inside deterministic()
    assert pcommon.dropout(x, 0.3, False) is x
    assert pcommon.dropout(x, 0.0, True) is x
    with pcommon.dropout_generator(gen), pcommon.deterministic():
        assert pcommon.dropout(x, 0.3, True) is x
    # the same generator state gives the same masks; the global random
    # state is neither read nor advanced
    state = gen.get_state()
    torch.manual_seed(1)
    before = torch.random.get_rng_state()
    with pcommon.dropout_generator(gen):
        a = pcommon.dropout(x[:1000], 0.5, True)
    gen.set_state(state)
    torch.manual_seed(2)
    with pcommon.dropout_generator(gen):
        b = pcommon.dropout(x[:1000], 0.5, True)
    assert torch.equal(a, b)
    torch.manual_seed(1)
    assert torch.equal(torch.random.get_rng_state(), before)
    with pytest.raises(RuntimeError, match="dropout_generator"):
        pcommon.dropout(x, 0.1, True)


def test_srl_model_dropout_in_train_mode_only(env):
    """``forward`` draws masks in train(), none in eval(); decoding is
    deterministic in either mode."""
    paths, root, comm, batch = env
    cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg",
                  **{"tx_dec.attention_dropout": 0.2})
    pm = psel.init_model_variables(psel.build_model(cfg, comm), 1)
    inp = to_torch(batch)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad(), pcommon.dropout_generator(gen):
        state = gen.get_state()
        a = float(pm(inp)["loss"])
        b = float(pm(inp)["loss"])
        gen.set_state(state)
        c = float(pm(inp)["loss"])
        pm.eval()
        d = float(pm(inp)["loss"])
        state = gen.get_state()
        pm.train()
        enc = pm.gen_encode(inp)[0]
        pm.eval()
        assert torch.equal(enc, pm.gen_encode(inp)[0])
        assert torch.equal(gen.get_state(), state)
    assert a != b and a == c and d not in (a, b)


def test_flax_style_init_of_the_language_models(env):
    """init_model_variables: token embeddings normal(d**-0.5), learned
    positions flax's default, LayerNorm ones and zeros, zero biases,
    lecun_normal kernels; the same values again from the same seed."""
    paths, root, comm, _ = env
    cfg = srl_cfg(paths, root, "new_gpt2_only")
    m = psel.init_model_variables(psel.build_model(cfg, comm), 5)
    sd = m.state_dict()
    emb = sd["decoder.embed_tokens.weight"]
    assert abs(emb.std().item() * 64 ** 0.5 - 1) < 0.05
    pos = sd["decoder.embed_positions.weight"]
    assert pos.abs().max() <= 2 * 64 ** -0.5 / 0.8796 + 1e-6
    assert torch.equal(sd["decoder.ln_f.weight"], torch.ones(64))
    assert not sd["decoder.layers_0.ffn.fc1.bias"].any()
    again = psel.init_model_variables(psel.build_model(cfg, comm), 5)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


# -- CLI ----------------------------------------------------------------------
def _cli(paths, root, uid, *extra):
    kv = {**paths, **TINY, "misc.tmp_path": str(root / "tmp")}
    return [uid, "--task_type=vb_arg", "--mdl.mdl_name=sfpret_txe_txd_vbarg",
            "--train.dtype=float32", "--train.bs=2", "--train.bsv=2",
            "--train.nw=0", "--train.nwv=0", "--gen.max_len_b=12",
            "--gen.beam_size=2", "--tpu.ancestry_beam=False",
            "--train.lr=1e-3", "--device=cpu", "--run_final_val=False",
            "--train.save_mdl_epochs=True",
            *[f"--{k}={v}" for k, v in kv.items()], *extra]


def _weights(learner, epoch):
    return torch.load(learner.model_epoch_dir / f"mdl_ep_{epoch}.ckpt",
                      map_location="cpu", weights_only=True)


def test_cli_fits_two_epochs_and_resumes_bitwise(env, tmp_path):
    """Two epochs with dropout on (tx_dec.dropout 0.1), against one epoch
    and a resumed second: the same weights bit for bit. Without the dropout
    generator's state in the checkpoint the resumed epoch draws other masks
    and ends elsewhere."""
    paths, _, _, _ = env
    res = pmain.main(_cli(paths, tmp_path, "two", "--train.epochs=2"))
    learner = res["learner"]
    assert learner.model_file.is_file() and learner.num_epoch == 2
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    assert sorted(p["ann_idx"] for p in preds) == [0, 1, 2]
    two = _weights(learner, 2)
    one = pmain.main(_cli(paths, tmp_path, "one", "--train.epochs=1"))
    ckpt = one["learner"].model_epoch_dir / "mdl_ep_1.ckpt"
    assert "dropout_rng" in _weights(one["learner"], 1)
    resumed = pmain.main(_cli(paths, tmp_path, "one", "--train.epochs=1",
                              "--train.resume=True",
                              f"--train.resume_path={ckpt}"))
    assert resumed["learner"].num_epoch == 2
    got = _weights(resumed["learner"], 2)
    for k, v in two["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    assert torch.equal(got["dropout_rng"], two["dropout_rng"])
    # control: the same resume with the generator restarted differs
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    del payload["dropout_rng"]
    torch.save(payload, tmp_path / "no_rng.ckpt")
    again = pmain.main(_cli(paths, tmp_path, "norng", "--train.epochs=1",
                            "--train.resume=True",
                            f"--train.resume_path={tmp_path / 'no_rng.ckpt'}"))
    w = _weights(again["learner"], 2)["model_state_dict"]
    assert any(not torch.equal(w[k], v)
               for k, v in two["model_state_dict"].items())


def test_only_val_on_fitted_weights_matches_jax(env, tmp_path):
    """Weights fitted in the port, carried into the JAX package through
    state_dict_to_flax: the same valid_0.pkl and metrics from both
    package's evaluators, in float32."""
    paths, _, comm, _ = env
    res = pmain.main(_cli(paths, tmp_path, "fit", "--train.epochs=1"))
    model = res["learner"].model
    wfile = tmp_path / "srl.pt"
    torch.save(model.state_dict(), wfile)
    val = pmain.main(_cli(paths, tmp_path, "val", "--only_val=True",
                          f"--weights={wfile}"))
    with open(val["pred_dir"] / "valid_0.pkl", "rb") as f:
        ppred = pickle.load(f)
    cfg = val["cfg"]
    jm = jsel.build_model(cfg, comm)
    tree = state_dict_to_flax(model.state_dict(), model)
    jdir = tmp_path / "jax_preds"
    _, jacc = JEvalB_Gen(cfg, comm, jsel.build_srl_generate_fn(cfg, comm, jm))(
        tree, get_data(cfg).valid_dl, "valid", jdir)
    with open(jdir / "valid_0.pkl", "rb") as f:
        jpred = pickle.load(f)
    assert len(ppred) == 3 and ppred == jpred
    assert val["results"]["valid"][1] == jacc


def test_state_dict_to_flax_inverts_flax_to_state_dict(env):
    paths, root, comm, _ = env
    for mdl in ("new_gpt2_only", "sfpret_txe_txd_vbarg"):
        pm = psel.build_model(srl_cfg(paths, root, mdl), comm)
        tree = seeded_variables(pm, 2)
        back = state_dict_to_flax(flax_to_state_dict(tree), pm)
        flat = jax.tree_util.tree_leaves_with_path
        assert [(p, a.shape) for p, a in flat(back)] == [
            (p, np.asarray(a).shape) for p, a in flat(tree)]
        for (_, a), (_, b) in zip(flat(back), flat(tree)):
            np.testing.assert_array_equal(a, b)


# -- pretrained GPT-2 ----------------------------------------------------------
def _seeded_gpt2(rng, n_layers, d, vocab, n_pos):
    sd = {"transformer.wte.weight": (vocab, d),
          "transformer.wpe.weight": (n_pos, d),
          "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,)}
    for i in range(n_layers):
        h = f"transformer.h.{i}."
        sd.update({h + "ln_1.weight": (d,), h + "ln_1.bias": (d,),
                   h + "attn.c_attn.weight": (d, 3 * d),
                   h + "attn.c_attn.bias": (3 * d,),
                   h + "attn.c_proj.weight": (d, d),
                   h + "attn.c_proj.bias": (d,),
                   h + "ln_2.weight": (d,), h + "ln_2.bias": (d,),
                   h + "mlp.c_fc.weight": (d, 4 * d),
                   h + "mlp.c_fc.bias": (4 * d,),
                   h + "mlp.c_proj.weight": (4 * d, d),
                   h + "mlp.c_proj.bias": (d,)})
    return {k: torch.from_numpy(0.05 * rng.standard_normal(s).astype(
        np.float32)) for k, s in sd.items()}


def test_gpt2_checkpoint_loads_like_jax(env, tmp_path):
    """mdl.gpt2_mdl_path: the HF checkpoint through the port's
    convert_gpt2 (vocabulary resized to the tokenizer's 427 rows, new rows
    seeded as the JAX package seeds them) replaces the decoder; equal to the
    JAX package's tree for the same file. An empty path keeps the initial
    values."""
    paths, root, comm, batch = env
    ckpt = tmp_path / "gpt2.pt"
    torch.save(_seeded_gpt2(np.random.default_rng(0), 2, 64, 50, 128), ckpt)
    cfg = srl_cfg(paths, root, "new_gpt2_only",
                  **{"mdl.gpt2_mdl_path": str(ckpt)})
    pm = psel.init_model_variables(psel.build_model(cfg, comm), 0)
    fresh = {k: v.clone() for k, v in pm.state_dict().items()}
    load_pretrained_variables(cfg, pm)
    jm = jsel.build_model(cfg, comm)
    jvars = jsel.init_model_variables(jm, batch)
    want = flax_to_state_dict(jax.tree.map(
        np.asarray, jax_load_pretrained(cfg, jm, jvars)))
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(got["decoder.embed_tokens.weight"],
                           fresh["decoder.embed_tokens.weight"])
    empty = srl_cfg(paths, root, "new_gpt2_only")
    load_pretrained_variables(empty, pm)
    assert torch.equal(pm.state_dict()["decoder.ln_f.bias"],
                       want["decoder.ln_f.bias"])
