"""Port SRL decoding (vidsitu_tpu_torch/gen/generate.py, the evaluator and
the CLI) against the JAX package's ``make_srl_generator`` and ``EvalB_Gen``
on a synthetic split, in float32 on the CPU, with one seeded weight tree
given to both. Tokens must be equal exactly, and so must the prediction
pickles and the metrics computed from them.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_transformer import TINY, build_pair, srl_cfg, to_torch
from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu.evaluation.evaluators import EvalB_Gen as JEvalB_Gen
from vidsitu_tpu.models import selector as jsel
from vidsitu_tpu_torch import main as pmain
from vidsitu_tpu_torch.evaluation.evaluators import EvalB_Gen
from vidsitu_tpu_torch.models import selector as psel

torch.set_num_threads(1)

GEN = {"gen.max_len_b": 20}  # 21 steps; segments of 4, 8, 16 where asked


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srl_gen")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=2,
                               seed=5)
    cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg")
    return paths, root, build_comm(cfg), next(iter(get_data(cfg).valid_dl))


GEN_CASES = {
    "greedy": ("sfpret_txe_txd_vbarg", {"gen.beam_size": 1}),
    "beam3_ancestry": ("sfpret_txe_txd_vbarg", {"gen.beam_size": 3}),
    "beam3_reorder_seg4": ("sfpret_txe_txd_vbarg", {
        "gen.beam_size": 3, "tpu.ancestry_beam": False,
        "tpu.seg_decode_min": 4}),
    "gpt2_beam3": ("new_gpt2_only", {"gen.beam_size": 3}),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generator_tokens_match_jax(env, case):
    paths, root, comm, batch = env
    mdl_name, kw = GEN_CASES[case]
    cfg = srl_cfg(paths, root, mdl_name, **GEN, **kw)
    jmodel, pmodel, tree = build_pair(cfg, comm, seed=11)
    ref = np.asarray(jsel.build_srl_generate_fn(cfg, comm, jmodel)(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}))
    gen = psel.build_srl_generate_fn(cfg, comm, pmodel)
    out = gen(to_torch(batch)).numpy()
    assert out.shape == ref.shape == (batch["seq_out_by_ev"].shape[0], 5, 1,
                                      21)
    np.testing.assert_array_equal(out, ref)
    # verb forcing: the first token is the event's verb token
    np.testing.assert_array_equal(out[:, :, 0, 0],
                                  batch["seq_out_by_ev"][:, :, 0, 0])
    assert gen.steps == [21]  # random weights never fill the quota early


def test_segmented_equals_single_loop_with_ancestry(env):
    """seg_decode_min 4 and 0 give the same tokens (ancestry table grown
    with identity columns between segments)."""
    paths, root, comm, batch = env
    outs = []
    for seg in (0, 4):
        cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg", **GEN, **{
            "gen.beam_size": 3, "tpu.seg_decode_min": seg})
        _, pmodel, _ = build_pair(cfg, comm, seed=11)
        outs.append(psel.build_srl_generate_fn(cfg, comm, pmodel)(
            to_torch(batch)).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_evaluator_matches_jax(env):
    """Same prediction dicts in the pickle, same metrics, on the whole
    valid split (3 segments in batches of 2: the last batch is padded)."""
    paths, root, comm, _ = env
    cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg", **GEN,
                  **{"gen.beam_size": 3, "tpu.ancestry_beam": False})
    jmodel, pmodel, tree = build_pair(cfg, comm, seed=12)
    dl = get_data(cfg).valid_dl
    jdir, pdir = root / "jax_preds", root / "port_preds"
    jdir.mkdir()
    _, jacc = JEvalB_Gen(cfg, comm, jsel.build_srl_generate_fn(
        cfg, comm, jmodel))(tree, dl, "valid", jdir)
    ev = EvalB_Gen(cfg, comm, psel.build_srl_generate_fn(cfg, comm, pmodel),
                   "cpu")
    _, pacc = ev(dl, "valid", pdir)
    with open(jdir / "valid_0.pkl", "rb") as f:
        jpred = pickle.load(f)
    with open(pdir / "valid_0.pkl", "rb") as f:
        ppred = pickle.load(f)
    assert len(ppred) == 3 and ppred == jpred
    assert set(pacc) == set(JEvalB_Gen.met_keys) and pacc == jacc
    assert len(ev.batch_seconds) == 2


def _cli_args(paths, root, *extra):
    args = ["cli_srl", "--task_type=vb_arg",
            "--mdl.mdl_name=sfpret_txe_txd_vbarg", "--train.dtype=float32",
            "--train.bsv=2", "--train.nwv=0", "--train.nw=0",
            "--gen.max_len_b=12", f"--misc.tmp_path={root / 'tmp'}",
            *[f"--{k}={v}" for k, v in {**paths, **TINY}.items()]]
    return args + list(extra)


def test_cli_only_val_writes_scored_pickle(env):
    paths, root, comm, _ = env
    res = pmain.main(_cli_args(paths, root, "--only_val=True",
                               "--device=cpu", "--allow_random_weights=True",
                               "--gen.beam_size=2",
                               "--tpu.ancestry_beam=False"))
    loss, acc = res["results"]["valid"]
    pkl = root / "tmp" / "predictions" / "cli_srl" / "valid_0.pkl"
    assert res["pred_dir"] / "valid_0.pkl" == pkl and pkl.exists()
    with open(pkl, "rb") as f:
        preds = pickle.load(f)
    assert sorted(p["ann_idx"] for p in preds) == [0, 1, 2]
    assert all(set(p["vb_output"]) == {f"Ev{i}" for i in range(1, 6)}
               for p in preds)
    assert set(acc) == set(EvalB_Gen.met_keys)
    assert all(np.isfinite(v) for v in acc.values())
    assert res["evaluator"].generate_fn.steps == [13, 13]


def test_cli_only_test_uses_test_split(env):
    paths, root, comm, _ = env
    res = pmain.main(_cli_args(paths, root, "--only_test=True",
                               "--device=cpu", "--allow_random_weights=True"))
    assert set(res["results"]) == {"test"}
    assert res["evaluator"].split_type == "test_srl"
    assert (res["pred_dir"] / "test_0.pkl").exists()


def test_cli_loads_state_dict_file(env, tmp_path):
    """--weights takes a torch file of the port's state_dict: the same
    weights decode the same tokens as the seeded ones they came from."""
    paths, root, comm, _ = env
    cfg = srl_cfg(paths, root, "sfpret_txe_txd_vbarg", **{"train.seed": 42})
    _, pmodel, _ = build_pair(cfg, comm, seed=42)
    wfile = tmp_path / "srl.pt"
    torch.save(pmodel.state_dict(), wfile)
    runs = []
    for flag in (f"--weights={wfile}", "--allow_random_weights=True"):
        res = pmain.main(_cli_args(paths, root, "--only_val=True",
                                   "--device=cpu", flag))
        with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
            runs.append((pickle.load(f), res["results"]))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("extra,error", [
    ((), SystemExit),                                  # no weights
])
def test_cli_refusals(env, extra, error):
    paths, root, comm, _ = env
    args = _cli_args(paths, root, "--device=cpu", *extra)
    if not extra:
        args.append("--only_val=True")
    with pytest.raises(error):
        pmain.main(args)


def test_cli_cuda_without_gpu_raises(env, monkeypatch):
    paths, root, comm, _ = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pmain.main(_cli_args(paths, root, "--only_val=True", "--device=cuda",
                             "--allow_random_weights=True"))
