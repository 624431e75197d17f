"""The port's tensor parallelism (``parallel/tensor.py``) on the CPU in
float64, against the JAX package's ``tp_spec`` rules and against one
process (2 gloo ranks through tests/torch_dist_child.py, mode ``steps``).

  * The split rules: ``tp_plan`` names exactly the leaves that
    ``vidsitu_tpu.parallel.mesh.tp_spec`` shards, on the same dimension,
    for the SRL, GPT-2 and evrel models (the relative transformer and the
    RoBERTa head stay whole), an indivisible head count (n = 3 of 4 heads)
    and a mixed module (3 heads, ffn 64, n = 2: attention replicated, the
    FFN split); a mesh with a ``model`` axis has its groups; an unknown
    axis still raises.
  * One split attention module and one split FFN on 2 ranks, with dropout
    0.1, against the whole module: the output, the input's gradient and
    every parameter's gradient (gathered whole); ``reduce_from_model`` sums
    forward and passes the gradient, ``copy_to_model`` sums the gradient.
  * SRL decoding of ``tx_only`` on ``[1, 2]`` at beam 3 on the reorder
    route: the merged pickle equals one process's, each rank's cache holds
    2 of the 4 heads, and with a counting stand-in for the row gather the
    reorders equal the decode steps on each rank.
  * Checkpoints: a ``[1, 2]`` run saved mid-way through a ``grad_accum=2``
    cycle resumes on one process, and one process's on ``[1, 2]``, through
    the pickle and the orbax backends, against 6 straight steps on one
    process within 1e-9 of each leaf's scale; the files hold whole tensors.
  * ``python -m vidsitu_tpu_torch.main`` on 2 ranks fits and validates
    ``vb_arg`` on ``['data', 'model']`` and ``['data', 'model', 'fsdp']``,
    ``evrel`` on ``['data', 'model']`` and ``vb`` (a tiny I3D-NL, which
    replicates) on ``['data', 'model']``, at lr 0 (float32): the metrics
    and merged predictions equal one process's (evrel's probabilities to
    float32 rounding).
"""

import copy

import numpy as np
import pytest
import torch

from tests.test_torch_elastic_resume import _check_close, _srl_cfg, _srl_model
from tests.test_torch_evrel import TINY_ROB, evrel_cfg
from tests.test_torch_learner import TINY as VB_TINY
from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import launch, run_case
from vidsitu_tpu.parallel.mesh import tp_spec
from vidsitu_tpu_torch import main as port_main
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
)
from vidsitu_tpu_torch.data import build_comm, get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import common
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models.transformer import FFN, MultiHeadAttention
from vidsitu_tpu_torch.parallel import mesh as M
from vidsitu_tpu_torch.parallel.tensor import tp_plan
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

TOL = 1e-9
LR = 1e-3
TP12 = {"tpu.mesh_shape": "[1, 2]", "tpu.mesh_axis_names": "['data', 'model']"}
LANG = {"task_type": "vb_arg", "mdl.mdl_name": "tx_only",
        "train.dtype": "float32"}
ACCUM = {**LANG, "train.grad_accum": 2}
DECODE = {"gen.beam_size": 3, "gen.max_len_b": 6, "tpu.ancestry_beam": False}


# -- the split rules -----------------------------------------------------------
def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_split(pm, n):
    """``tp_spec``'s verdict on every leaf of ``pm``'s flax-layout tree, by
    the port's parameter name: the split dimension of the torch tensor
    (a kernel's sharded input axis is the torch weight's dim 1, its output
    axes dim 0; a bias's dim 0)."""
    out = {}
    for path, arr in _flax_leaves(seeded_variables(pm, 0)["params"]):
        spec = tp_spec("/".join(path), arr.shape, n)
        name = next(iter(flax_to_state_dict(
            {"params": _nest(path, arr)})))
        if spec is not None:
            axis = list(spec).index("model")
            out[name] = (1 if axis == 0 else 0) if path[-1] == "kernel" \
                else 0
    return out


def _nest(path, arr):
    tree = arr
    for k in reversed(path):
        tree = {k: tree}
    return tree


def _build(tmp_path, task, mdl, **kw):
    paths = make_synth_dataset(tmp_path / "data", n_train=2, n_valid=2,
                               n_test=1, seed=3)
    if task == "evrel":
        cfg = evrel_cfg(paths, tmp_path, mdl, **kw)
    else:
        cfg = _srl_cfg(paths, tmp_path, **{"mdl.mdl_name": mdl, **kw})
    return psel.build_model(cfg, build_comm(cfg))


RULE_CASES = [("vb_arg", "tx_only", 2), ("vb_arg", "tx_only", 4),
              ("vb_arg", "tx_only", 3), ("vb_arg", "sfpret_txe_txd_vbarg", 2),
              ("vb_arg", "new_gpt2_only", 2), ("evrel", "rob_evrel", 2),
              ("evrel", "sfpret_evrel", 2)]


@pytest.mark.parametrize("task,mdl,n", RULE_CASES,
                         ids=[f"{m}-{n}" for _, m, n in RULE_CASES])
def test_tp_plan_matches_tp_spec(tmp_path, task, mdl, n):
    pm = _build(tmp_path, task, mdl)
    want = _jax_split(pm, n)
    assert tp_plan(pm, n) == want
    assert bool(want) == (n != 3)  # 4 heads / ffn 128 do not split 3 ways
    assert not any(k.startswith(("rel_tx", "vis_lang", "classf_head"))
                   for k in want)


def test_mixed_module_splits_the_ffn_only(tmp_path):
    """3 heads, ffn 64, n = 2: the attention stays whole, the FFN splits."""
    pm = _build(tmp_path, "vb_arg", "tx_only", **{
        "tx_dec.decoder_embed_dim": 48, "tx_dec.decoder_attention_heads": 3,
        "tx_dec.decoder_ffn_embed_dim": 64})
    plan = tp_plan(pm, 2)
    assert plan == _jax_split(pm, 2)
    assert plan and all(".ffn.fc" in k for k in plan)
    for i in range(pm.dec_cfg.n_layers):
        pre = f"decoder.layers_{i}.ffn."
        assert {k: v for k, v in plan.items() if k.startswith(pre)} == {
            pre + "fc1.weight": 0, pre + "fc1.bias": 0, pre + "fc2.weight": 1}


@pytest.mark.parametrize("axes,shape,want", [
    (["data", "model"], "[-1, 2]", (2, 2)),
    (["data", "model", "fsdp"], "[1, 2, 2]", (1, 2, 2)),
    (["data", "tensor"], "[-1, 2]", None)], ids=["axes1", "axes2", "unknown"])
def test_model_axis_mesh_shape(axes, shape, want):
    """The ``model`` axis is read like the others; an unknown axis raises
    (the groups of a ``model`` mesh: ``test_split_modules_equal_whole``)."""
    cfg = get_cfg_with_overrides("t", **{"tpu.mesh_axis_names": str(axes),
                                         "tpu.mesh_shape": shape})
    if want is None:
        with pytest.raises(ValueError, match="at most once"):
            M.mesh_shape(cfg, 4)
    else:
        assert M.mesh_shape(cfg, 4) == want


# -- two ranks: modules, decoding, checkpoints ---------------------------------
def _module_cases(tmp):
    rng = np.random.default_rng(13)
    mods = {"attention": MultiHeadAttention(16, 4, torch.float64, 0.1),
            "ffn": FFN(16, 32, torch.float64, "gelu_exact", 0.1)}
    cases = {}
    for name, mod in mods.items():
        common.init_like_flax(mod, 3)
        for p in mod.parameters():  # non-zero biases
            p.data += torch.from_numpy(rng.normal(0, 0.1, p.shape))
        mod = mod.double()
        case = {"module": mod, "attention": name == "attention",
                "x": torch.from_numpy(rng.normal(size=(2, 3, 16))),
                "dy": torch.from_numpy(rng.normal(size=(2, 3, 16)))}
        torch.save(case, tmp / f"{name}.pt")
        cases[name] = case
    return cases


def _whole_module(case):
    mod = copy.deepcopy(case["module"]).train()
    x = case["x"].clone().requires_grad_(True)
    with common.dropout_generator(torch.Generator().manual_seed(5)):
        y = mod(*([x, x] if case["attention"] else [x]))
        y = y[0] if isinstance(y, tuple) else y
    (y * case["dy"]).sum().backward()
    return {"y": y.detach(), "dx": x.grad,
            "grads": {n: p.grad for n, p in mod.named_parameters()}}


def _case(name, model, cfg, batches, **kw):
    return {"name": name, "model": copy.deepcopy(model), "cfg": cfg,
            "lr": LR, "batches": [[b] for b in batches], **kw}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    paths = make_synth_dataset(tmp / "data", n_train=12, n_valid=4,
                               n_test=1, seed=101)
    cfg = _srl_cfg(paths, tmp / "cfg", **{
        "tx_dec.attention_dropout": 0.1, "tx_dec.activation_dropout": 0.1})
    batches = list(get_data(cfg).train_dl)
    assert len(batches) == 6
    tx = _srl_model(cfg, dropout=True)
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    orbax = {"train.ckpt_backend": "orbax"}
    one_tmp = str(tmp / "one")
    one = {"straight": run_case(_case("s", tx, ACCUM, batches), 0, one_tmp)}
    for tag, over in (("pickle", {}), ("orbax", orbax)):
        one[f"save_{tag}"] = run_case(_case(
            "a", tx, {**ACCUM, **over}, batches[:3],
            save=str(ckpt / f"one_{tag}")), 0, one_tmp)
    decode = {**paths, **SRL_TINY, **LANG, **DECODE, "train.bsv": 2,
              "train.nw": 0, "train.nwv": 0}
    two = {"decode": _case("tx", tx, {**decode, **TP12}, [], validate=True)}
    for tag, over in (("pickle", {}), ("orbax", orbax)):
        two[f"save_{tag}"] = _case("a", tx, {**ACCUM, **TP12, **over},
                                   batches[:3], save=str(ckpt / f"tp_{tag}"))
        two[f"grow_{tag}"] = _case("g", tx, {**ACCUM, **TP12, **over},
                                   batches[3:],
                                   resume=str(ckpt / f"one_{tag}"))
    files = []
    for key, case in two.items():
        case["name"] = key
        torch.save(case, tmp / f"{key}.pt")
        files.append(str(tmp / f"{key}.pt"))
    mods = _module_cases(tmp)
    outs, _ = launch("steps", {
        "cases": files, "tmp": str(tmp / "two"),
        "modules": {"cfg": TP12, "cases": {
            n: str(tmp / f"{n}.pt") for n in mods}}}, tmp)
    for tag, over in (("pickle", {}), ("orbax", orbax)):
        one[f"shrink_{tag}"] = run_case(_case(
            "r", tx, {**ACCUM, **over}, batches[3:],
            resume=str(ckpt / f"tp_{tag}")), 0, one_tmp)
    one["decode"] = run_case(_case("tx", tx, decode, [], validate=True), 0,
                             str(tmp / "dec"))
    return {"one": one, "outs": outs, "mods": mods, "ckpt": ckpt,
            "model": tx}


@pytest.mark.parametrize("name", ["attention", "ffn"])
def test_split_modules_equal_whole(runs, name):
    want = _whole_module(runs["mods"][name])
    for out in runs["outs"]:
        got = out["modules"][name]
        for key in ("y", "dx"):
            _check_close({key: got[key]}, {key: want[key]}, 1e-12)
        _check_close(got["grads"], want["grads"], 1e-12)
        if name == "attention":
            assert got["heads"] == 2


def test_reduce_and_copy_functions(runs):
    for out in runs["outs"]:
        res = out["modules"]
        assert res["reduce"]["fwd"].tolist() == [3.0] * 3  # 1 + 2
        assert res["reduce"]["grad"].tolist() == [0.0, 1.0, 2.0]
        assert res["copy"]["grad"].tolist() == [3.0] * 3


def test_tp_decode_equals_one_process(runs):
    want = runs["one"]["decode"]["validate"]
    outs = [o["decode"]["validate"] for o in runs["outs"]]
    assert want["pred"] and outs[0]["pred"] == want["pred"]
    assert outs[0]["steps"] == outs[1]["steps"] == want["steps"]
    assert want["gathers"] == sum(want["steps"]) > 0
    assert all(h == [4] for h in want["heads"])
    for o in outs:
        assert o["gathers"] == sum(o["steps"])
        assert all(h == [2] for h in o["heads"]), o["heads"]


@pytest.mark.parametrize("tag", ["shrink_pickle", "shrink_orbax",
                                 "grow_pickle", "grow_orbax"])
def test_tp_checkpoint_resumes_across_meshes(runs, tag):
    """Saved at step 3 (a grad_accum cycle in flight) on one mesh, resumed
    for steps 4-6 on the other: 6 straight steps on one process."""
    straight = runs["one"]["straight"]
    if tag.startswith("shrink"):
        got = [runs["one"][tag]]
    else:
        got = [o[tag] for o in runs["outs"]]
    for res in got:
        assert res["num_it"] == straight["num_it"] == 6
        assert res["accum_count"] == 0
        for a, b in zip(res["losses"], straight["losses"][3:]):
            assert abs(a - b) <= TOL * abs(b), (a, b)
        _check_close(res["grads"], straight["grads"], TOL)
        _check_close(res["state_dict"], straight["state_dict"], TOL)


def test_tp_pickle_holds_whole_tensors(runs):
    saved = torch.load(runs["ckpt"] / "tp_pickle", weights_only=True)
    model = runs["model"]
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert saved["world_size"] == 2 and saved["accum_count"] == 1
    for n, v in saved["model_state_dict"].items():
        assert v.shape == model.state_dict()[n].shape, n
    for n, st in saved["optimizer_state_dict"]["state"].items():
        assert st["exp_avg"].shape == shapes[n], n
    assert {n: g.shape for n, g in saved["accum_grads"].items()} == shapes
    one = torch.load(runs["ckpt"] / "one_pickle", weights_only=True)
    _check_close(saved["accum_grads"], one["accum_grads"], TOL)


# -- the entry point -------------------------------------------------------------
CLI = {"vb_arg": {**SRL_TINY, **LANG, **DECODE},
       "evrel": {**TINY_ROB, "task_type": "evrel",
                 "mdl.mdl_name": "rob_evrel", "train.dtype": "float32"},
       "vb": VB_TINY}
CLI_MESHES = {
    "dm": ["--tpu.mesh_shape=[1, 2]",
           "--tpu.mesh_axis_names=['data', 'model']"],
    "dmf": ["--tpu.mesh_shape=[1, 2, 1]",
            "--tpu.mesh_axis_names=['data', 'model', 'fsdp']"]}
CLI_RUNS = (("vb_arg", "dm"), ("vb_arg", "dmf"), ("evrel", "dm"),
            ("vb", "dm"))


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_cli")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3,
                               n_test=1, with_frames=True, seed=103)

    def argv(uid, task, *extra):
        kv = {**paths, **CLI[task], "train.bs": 2, "train.bsv": 2,
              "train.nw": 0, "train.nwv": 0, "train.lr": 0.0,
              "train.epochs": 1, "run_final_val": False,
              "misc.tmp_path": str(root / "tmp")}
        return [uid, *[f"--{k}={v}" for k, v in kv.items()], "--device=cpu",
                *extra]

    outs, _ = launch("main", {"runs": [
        argv(f"{t}_{m}", t, *CLI_MESHES[m]) for t, m in CLI_RUNS]},
        root / "tp")
    one = {t: port_main.main(argv(f"{t}_one", t))
           for t in ("vb_arg", "evrel", "vb")}
    return {"outs": outs, "one": one, "pred": root / "tmp" / "predictions"}


@pytest.mark.parametrize("i", range(len(CLI_RUNS)),
                         ids=[f"{t}-{m}" for t, m in CLI_RUNS])
def test_tp_cli_fits_and_validates(cli, i):
    import pickle

    task, mesh = CLI_RUNS[i]
    runs = [o["runs"][i] for o in cli["outs"]]
    assert all(r["num_epoch"] == 1 and r["num_it"] == 2 for r in runs)
    assert runs[0]["results"] == runs[1]["results"]
    assert runs[0]["results"] == {k: [dict(v[0]), dict(v[1])] for k, v in
                                  cli["one"][task]["results"].items()}

    def load(uid):
        with open(cli["pred"] / uid / "valid_0.pkl", "rb") as f:
            return pickle.load(f)

    got, want = load(f"{task}_{mesh}"), load(f"{task}_one")
    if task == "evrel":
        # float32 logits of split layers round otherwise: the relations
        # are equal, their probabilities close
        for g, w in zip(got, want):
            assert g["ann_idx"] == w["ann_idx"]
            assert g["pred_evrels_ev"] == w["pred_evrels_ev"]
            np.testing.assert_allclose(g["pred_scores_ev"],
                                       w["pred_scores_ev"], rtol=1e-5)
        assert len(got) == len(want)
    else:
        assert got == want
    if task == "vb_arg":
        assert runs[0]["decode_steps"] == runs[1]["decode_steps"]
        assert runs[0]["sharded"] == (mesh == "dmf")
