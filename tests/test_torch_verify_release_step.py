"""``--train_step`` of the port's release harness against the JAX
package's, on the CPU at the JAX tests' tiny sizes: one step of each
package from the JAX package's initial variables, with every dropout rate
0 and float32 products, on the same 2-item batch of the fabricated release
(tests/test_torch_verify_release.py): the loss within 1e-5 of JAX's and as
many parameter tensors moved, for ``vb_arg/tx_only``,
``vb_arg/sfpret_txe_txd_vbarg`` and ``vb/sf_base`` on the depth-26
backbone at 32 px. The port's check itself, from its own flax-like initial
values, passes on each.
"""

import numpy as np
import pytest
import torch

import vidsitu_tpu.verify_release as jvr
import vidsitu_tpu_torch.verify_release as pvr
from tests.test_torch_verify_release import release  # noqa: F401 (fixture)

torch.set_num_threads(1)

LOSS_TOL = 1e-5


SRL_TINY = {
    "tx_dec.decoder_embed_dim": 64, "tx_dec.decoder_ffn_embed_dim": 128,
    "tx_dec.decoder_layers": 2, "tx_dec.decoder_attention_heads": 4,
    "tx_dec.encoder_embed_dim": 64, "tx_dec.encoder_ffn_embed_dim": 128,
    "tx_dec.encoder_layers": 2, "tx_dec.encoder_attention_heads": 4,
    "tx_dec.dropout": 0.0, "tx_dec.attention_dropout": 0.0,
    "tx_dec.activation_dropout": 0.0,
}
STEP_CASES = {
    "vb_arg/tx_only": (None, SRL_TINY),
    "vb_arg/sfpret_txe_txd_vbarg": ("i3d_synth", SRL_TINY),
    "vb/sf_base": (None, {"vid_mdl.resnet.depth": 26,
                          "vid_mdl.crop_size": 32,
                          "vid_mdl.num_frames": 4}),
}


def _jax_step(cfg):
    """The JAX package's ``train_step_check`` step (value_and_grad of the
    training-mode loss, optax.adam(1e-4)) from its own initial variables;
    the loss, the moved-leaf count and the initial variables."""
    import jax
    import optax

    from vidsitu_tpu.data import build_comm
    from vidsitu_tpu.data.dataset import VsituDS
    from vidsitu_tpu.data.loader import fold_frame_events, stack_collate
    from vidsitu_tpu.models.selector import build_model, init_model_variables

    comm = build_comm(cfg)
    ds = VsituDS(cfg, comm, "train")
    batch = fold_frame_events(stack_collate([ds[i] for i in range(2)]))
    model = build_model(cfg, comm)
    variables = jax.device_get(init_model_variables(model, batch, seed=0))
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}

    @jax.jit
    def step(p, b):
        def loss_fn(pp):
            out, new = model.apply({"params": pp, **extra}, b,
                                   deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=list(extra))
            return out["loss"], new

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        opt = optax.adam(1e-4)
        upd, _ = opt.update(grads, opt.init(p), p)
        return loss, optax.apply_updates(p, upd)

    loss, p2 = step(params, batch)
    moved = sum(int(bool(np.any(np.asarray(a) != np.asarray(b))))
                for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)))
    return float(loss), moved, variables


@pytest.fixture(scope="module")
def vocab_dirs(release, tmp_path_factory):  # noqa: F811
    """The release's vocabs converted by the port's checks, and the
    RoBERTa stand-in that ``main`` builds when no tokenizer dir is given."""
    from vidsitu_tpu_torch.tokenization.bpe import ByteLevelBPE
    from vidsitu_tpu_torch.tokenization.tokenizer import (
        make_roberta_tokenizer,
    )

    conv = tmp_path_factory.mktemp("converted")
    rep = pvr.Report()
    dirs = {"verb": pvr.check_verb_vocab(release, rep, conv),
            "gpt2": pvr.check_gpt2_pickle(release, rep, conv),
            "roberta": conv / "roberta_standin_vocab"}
    make_roberta_tokenizer(ByteLevelBPE.from_dir(dirs["gpt2"])).save_dir(
        dirs["roberta"])
    assert len(rep.passed) == 2
    return dirs


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax_from_its_initial_variables(
        release, vocab_dirs, case):  # noqa: F811
    from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict

    task, mdl = case.split("/")
    feats, tiny = STEP_CASES[case]
    over = {**tiny, "train.dtype": "float32"}
    jcfg = jvr._release_cfg(release, vocab_dirs, task, mdl, feats)
    for k, v in over.items():
        jcfg.set_dotted(k, v)
    jloss, jmoved, variables = _jax_step(jcfg)
    pcfg = pvr._release_cfg(release, vocab_dirs, task, mdl, feats, over)
    res = pvr.release_train_step(pcfg, "cpu",
                                 state_dict=flax_to_state_dict(variables))
    assert abs(res["loss"] - jloss) <= LOSS_TOL * abs(jloss), (
        res["loss"], jloss)
    assert res["moved"] == jmoved, (res["moved"], jmoved)
    assert 0 < res["moved"] <= res["n_params"]
    assert res["ms"] > 0 and res["peak_gib"] is None
    # the check's own line, from the port's flax-like initial values
    rep = pvr.Report()
    out = pvr.train_step_check(release, vocab_dirs, task, mdl, rep, feats,
                               device="cpu", overrides=over)
    assert rep.passed == [f"train step[{task}/{mdl}]"] and out["moved"] > 0


