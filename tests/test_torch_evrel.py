"""Event relations (evrel) in the port against the JAX package, on the CPU
at tiny RoBERTa widths (2 layers, d 64, 4 heads):

  * one Adam(0.9, 0.99) step of all five variants in float64 with every
    dropout rate 0, held as in tests/test_torch_srl_train.py;
  * the float32 logits of all five within 1e-4 of their scale, in eval
    mode and in train mode with the dropout stand-in at every site
    (RoBERTa's embedding LayerNorm, its layers, the classification head's
    two);
  * RoBERTa's HF position ids; ``max_pos = max(rc.max_pos, pad_id + 122)``;
    ``sfpret_onlyvid_evrel`` registering ``rob_mdl`` without running it;
    ``txe_evrel`` ignoring the video;
  * ``EvalB_Acc``: the same pickle, metrics and float64 validation loss as
    the JAX package's on the same weights, the loss over the real rows of
    a padded final batch only;
  * ``python -m vidsitu_tpu_torch.main --task_type=evrel``: a 2-epoch fit
    and its resume by uid;
  * the ``rob_mdl_path`` branch of the pretrained policy against the JAX
    package's, on a seeded HF-layout RoBERTa state dict.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_srl_train import (
    LOGIT_TOL,
    assert_close_to_scale,
    check_step,
    jax_adam_step,
    port_adam_step,
    standin_dropout,  # noqa: F401  (fixture)
    to_torch,
)
from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu.evaluation.evaluators import EvalB_Acc as JEvalB_Acc
from vidsitu_tpu.models import roberta as jroberta
from vidsitu_tpu.models import selector as jsel
from vidsitu_tpu.train.pretrained import (
    load_pretrained_variables as jax_load_pretrained,
)
from vidsitu_tpu.utils.config import get_cfg_with_overrides
from vidsitu_tpu_torch import main as pmain
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
    state_dict_to_flax,
)
from vidsitu_tpu_torch.evaluation.evaluators import EvalB_Acc
from vidsitu_tpu_torch.models import roberta as proberta
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models.evrel_models import EVREL_MDL_NAMES, EvrelModel
from vidsitu_tpu_torch.train.pretrained import load_pretrained_variables

torch.set_num_threads(1)

TINY_ROB = {
    "rob_mdl.d_model": 64,
    "rob_mdl.n_layers": 2,
    "rob_mdl.n_heads": 4,
    "rob_mdl.ffn_dim": 128,
    "rob_mdl.max_pos": 130,
}


def evrel_cfg(paths, root, mdl_name, **kw):
    return get_cfg_with_overrides("torch_evrel", **{
        **paths, **TINY_ROB, "task_type": "evrel", "mdl.mdl_name": mdl_name,
        "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
        "train.dtype": "float32", "misc.tmp_path": str(root / "tmp"), **kw})


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_evrel")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=1,
                               seed=41)
    cfg = evrel_cfg(paths, root, "sfpret_evrel")
    data = get_data(cfg)
    return (paths, root, build_comm(cfg), next(iter(data.train_dl)),
            next(iter(data.valid_dl)))


def _pair(cfg, comm, seed):
    pm = psel.build_model(cfg, comm)
    tree = seeded_variables(pm, seed)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    return jsel.build_model(cfg, comm), pm, tree


@pytest.mark.parametrize("mdl_name", EVREL_MDL_NAMES)
def test_adam_step_matches_jax_float64(env, tmp_path, mdl_name):
    paths, root, comm, batch, _ = env
    cfg = evrel_cfg(paths, tmp_path, mdl_name)
    jm, pm, tree = _pair(cfg, comm, seed=3)
    jm = jm.clone(rob_cfg=dataclasses.replace(
        jm.rob_cfg, dtype=jnp.float64, param_dtype=jnp.float64))
    pm = EvrelModel(mdl_name, dataclasses.replace(
        pm.rob_cfg, dtype=torch.float64, dropout=0.0), pm.feat_dim)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    ref = jax_adam_step(jm, tree, batch)
    loss, grads, model = port_adam_step(pm.double(), cfg, batch)
    check_step(ref, loss, grads, model)
    if mdl_name == "sfpret_onlyvid_evrel":  # the skipped language pathway
        assert all(not grads[n].any() for n in grads
                   if n.startswith("rob_mdl."))
    if mdl_name == "txe_evrel":  # the zeroed video
        assert not grads["vid_feat_encoder.layers_0.weight"].any()


@pytest.mark.parametrize("mdl_name", EVREL_MDL_NAMES)
def test_logits_match_jax_float32(env, mdl_name):
    paths, root, comm, _, batch = env
    jm, pm, tree = _pair(evrel_cfg(paths, root, mdl_name), comm, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jm.apply(tree, jb)
    pm.eval()
    with torch.no_grad():
        got = pm(to_torch(batch))
    assert got["mdl_out"].shape == (2, 4, 3, 5)
    assert_close_to_scale(got["mdl_out"].numpy(), want["mdl_out"], LOGIT_TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("mdl_name", ["rob_evrel", "sfpret_evrel"])
def test_dropout_sites_match_jax(env, standin_dropout, mdl_name):  # noqa: F811
    paths, root, comm, _, batch = env
    jm, pm, tree = _pair(evrel_cfg(paths, root, mdl_name), comm, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jm.apply(tree, jb, deterministic=False)["mdl_out"])
    pm.train()
    with torch.no_grad():
        got = pm(to_torch(batch))["mdl_out"].numpy()
        pm.eval()
        plain = pm(to_torch(batch))["mdl_out"].numpy()
    assert_close_to_scale(got, want, LOGIT_TOL)
    assert not np.allclose(got, plain, atol=1e-4)


def test_roberta_positions_and_table_size(env):
    ids = torch.tensor([[0, 5, 7, 1, 1], [0, 9, 1, 1, 1]])
    pos = proberta.position_ids_from_tokens(ids, 1)
    assert pos.tolist() == [[2, 3, 4, 1, 1], [2, 3, 1, 1, 1]]
    np.testing.assert_array_equal(pos.numpy(), np.asarray(
        jroberta.position_ids_from_tokens(jnp.asarray(ids.numpy()), 1)))
    paths, root, comm, _, _ = env
    pm = psel.build_model(evrel_cfg(paths, root, "rob_evrel"), comm)
    pad = comm.rob_hf_tok.pad_token_id
    assert pm.rob_cfg.max_pos == max(130, pad + 122) == pad + 122
    assert pm.rob_mdl.position_embeddings.weight.shape[0] == pad + 122
    assert not hasattr(pm.rob_mdl, "pooler_dense")


def test_onlyvid_registers_roberta_and_txe_ignores_video(env):
    paths, root, comm, _, batch = env
    _, pm, _ = _pair(evrel_cfg(paths, root, "sfpret_onlyvid_evrel"), comm, 6)
    assert any(n.startswith("rob_mdl.") for n in pm.state_dict())
    pm.eval()
    shuffled = dict(batch)
    shuffled["evrel_seq_out_ones"] = np.random.default_rng(0).permutation(
        batch["evrel_seq_out_ones"].reshape(-1)).reshape(
        batch["evrel_seq_out_ones"].shape)
    with torch.no_grad():
        assert torch.equal(pm.logits(to_torch(batch)),
                           pm.logits(to_torch(shuffled)))
    _, txe, _ = _pair(evrel_cfg(paths, root, "txe_evrel"), comm, 6)
    txe.eval()
    sevens = dict(batch, frm_feats=np.full_like(batch["frm_feats"], 7.0))
    with torch.no_grad():
        assert torch.equal(txe.logits(to_torch(batch)),
                           txe.logits(to_torch(sevens)))


def test_evaluator_matches_jax_on_a_partial_batch(env, tmp_path):
    """3 valid segments in batches of 2: the second is padded. Same pickle,
    metrics and validation loss as the JAX package's EvalB_Acc; the loss is
    the real rows' mean weighted by rows."""
    paths, root, comm, _, _ = env
    cfg = evrel_cfg(paths, root, "sfpret_evrel")
    jm, pm, tree = _pair(cfg, comm, seed=8)
    dl = get_data(cfg).valid_dl
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jloss, jacc = JEvalB_Acc(cfg, comm, jm)(tree, dl, "valid", jdir)
    ev = EvalB_Acc(cfg, comm, pm, "cpu")
    ploss, pacc = ev(dl, "valid", pdir)
    with open(jdir / "valid_0.pkl", "rb") as f:
        jpred = pickle.load(f)
    with open(pdir / "valid_0.pkl", "rb") as f:
        ppred = pickle.load(f)
    assert len(ppred) == 3 and [p["pred_evrels_ev"] for p in ppred] == [
        p["pred_evrels_ev"] for p in jpred]
    for p, j in zip(ppred, jpred):
        assert p["ann_idx"] == j["ann_idx"]
        np.testing.assert_allclose(p["pred_scores_ev"], j["pred_scores_ev"],
                                   rtol=1e-5)
    assert set(pacc) == set(EvalB_Acc.met_keys) and pacc == jacc
    np.testing.assert_allclose(ploss["loss"], jloss["loss"], rtol=1e-5)
    want, rows = [], []
    pm.eval()
    for b in dl:
        with torch.no_grad():
            want.append(float(pm(to_torch(b))["loss"]))
        rows.append(len(b["vseg_idx"]))
    assert rows == [2, 1]
    np.testing.assert_allclose(ploss["loss"], np.average(want, weights=rows),
                               rtol=1e-6)
    assert len(ev.batch_seconds) == 2


def test_cli_fits_two_epochs_and_resumes(env, tmp_path):
    """main.py --task_type=evrel: two epochs with dropout on, validated
    each epoch (the top-1 relation per pair in valid_0.pkl, finite
    metrics), then the same uid resumed for a third with the optimizer's
    state."""
    paths, _, _, _, _ = env
    kv = {**paths, **TINY_ROB, "misc.tmp_path": str(tmp_path / "tmp")}
    args = ["evrel_fit", "--task_type=evrel", "--mdl.mdl_name=sfpret_evrel",
            "--train.dtype=float32", "--train.bs=2", "--train.bsv=2",
            "--train.nw=0", "--train.nwv=0", "--train.epochs=2",
            "--train.save_mdl_epochs=True", "--device=cpu",
            *[f"--{k}={v}" for k, v in kv.items()]]
    res = pmain.main(args)
    learner = res["learner"]
    loss, acc = res["results"]["valid"]
    assert set(acc) == {"Macro_Top_1", "Top_1"}
    assert np.isfinite(loss["loss"]) and all(np.isfinite(list(acc.values())))
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    names = set(res["evaluator"].comm.evrel_dct_opp.values())
    assert sorted(p["ann_idx"] for p in preds) == [0, 1, 2]
    assert all(len(p["pred_evrels_ev"]) == 4 and all(
        len(row) == 3 and set(row) <= names for row in p["pred_evrels_ev"])
        for p in preds)
    ckpt = learner.model_epoch_dir / "mdl_ep_2.ckpt"
    res2 = pmain.main(args + ["--train.resume=True", "--train.epochs=1",
                              f"--train.resume_path={ckpt}",
                              "--run_final_val=False"])
    l2 = res2["learner"]
    assert (l2.num_epoch, l2.num_it) == (3, 6)
    assert int(l2.optimizer.state_dict()["state"][0]["step"]) == 6


def test_state_dict_to_flax_round_trip(env):
    paths, root, comm, _, _ = env
    for mdl in EVREL_MDL_NAMES:
        pm = psel.build_model(evrel_cfg(paths, root, mdl), comm)
        sd = flax_to_state_dict(seeded_variables(pm, 1))
        back = flax_to_state_dict(state_dict_to_flax(sd, pm))
        assert set(back) == set(sd)
        assert all(torch.equal(back[k], v) for k, v in sd.items())


def _seeded_roberta(rng, n_layers, d, vocab, n_pos, pooler=True):
    e, L = "roberta.embeddings.", "roberta.encoder.layer."
    sd = {e + "word_embeddings.weight": (vocab, d),
          e + "position_embeddings.weight": (n_pos, d),
          e + "token_type_embeddings.weight": (1, d),
          e + "LayerNorm.weight": (d,), e + "LayerNorm.bias": (d,),
          e + "position_ids": None}
    if pooler:
        sd.update({"roberta.pooler.dense.weight": (d, d),
                   "roberta.pooler.dense.bias": (d,)})
    for i in range(n_layers):
        p = f"{L}{i}."
        for name, dout, din in (("attention.self.query", d, d),
                                ("attention.self.key", d, d),
                                ("attention.self.value", d, d),
                                ("attention.output.dense", d, d),
                                ("intermediate.dense", 2 * d, d),
                                ("output.dense", d, 2 * d)):
            sd[p + name + ".weight"] = (dout, din)
            sd[p + name + ".bias"] = (dout,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = (d,)
            sd[p + ln + ".bias"] = (d,)
    return {k: (torch.arange(n_pos)[None] if s is None else torch.from_numpy(
        0.05 * rng.standard_normal(s).astype(np.float32)))
        for k, s in sd.items()}


@pytest.mark.parametrize("mdl_name", ["rob_evrel", "sfpret_evrel"])
def test_roberta_checkpoint_loads_like_jax(env, tmp_path, mdl_name):
    """mdl.rob_mdl_path: the HF checkpoint through the port's
    convert_roberta replaces rob_mdl (rob_evrel has no pooler; the heads
    keep their initial values), equal to the JAX package's tree for the
    same file."""
    paths, root, comm, batch, _ = env
    pad = comm.rob_hf_tok.pad_token_id
    ckpt = tmp_path / "roberta.pt"
    torch.save(_seeded_roberta(np.random.default_rng(1), 2, 64,
                               len(comm.rob_hf_tok), pad + 122), ckpt)
    cfg = evrel_cfg(paths, root, mdl_name, **{"mdl.rob_mdl_path": str(ckpt)})
    pm = psel.init_model_variables(psel.build_model(cfg, comm), 0)
    head = {k: v.clone() for k, v in pm.state_dict().items()
            if not k.startswith("rob_mdl.")}
    load_pretrained_variables(cfg, pm)
    jm = jsel.build_model(cfg, comm)
    jvars = jax_load_pretrained(cfg, jm, jsel.init_model_variables(jm, batch))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jvars))
    got = pm.state_dict()
    for k, v in got.items():
        if k.startswith("rob_mdl."):
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, head[k]), k


@pytest.mark.parametrize("task,mdl", [("evrel", "rob_evrel"),
                                      ("vb_arg", "sfpret_txe_txd_vbarg")])
def test_training_cli_defaults_to_cuda_and_raises_without_a_gpu(
        env, tmp_path, monkeypatch, task, mdl):
    paths, _, _, _, _ = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pmain.main(["nogpu", f"--task_type={task}", f"--mdl.mdl_name={mdl}",
                    f"--misc.tmp_path={tmp_path}",
                    *[f"--{k}={v}" for k, v in paths.items()]])
