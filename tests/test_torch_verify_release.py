"""The port's release harness (``python -m vidsitu_tpu_torch.verify_release``)
against the JAX package's (``python -m vidsitu_tpu.verify_release``) on the
CPU, at the JAX tests' tiny sizes: the same fabricated inputs through both
``main``s print the same check names with the same statuses, in the same
order, and exit with the same code.

  * the fabricated release (``make_release_tree(with_frames=True,
    frame_hw=64)``): rc 0, and the converted vocab files equal byte for
    byte;
  * corruptions (those of tests/test_verify_release.py and a truncated
    vinfo file): the same ``[FAIL]`` names and exit code;
  * ``--weights`` on the weights fabricated by tests/test_verify_release.py
    (HF GPT-2 / RoBERTa, a caffe2 SlowFast pickle, a trained SFBase .pth
    loaded into the port's model with ``strict=True``, an unrecognised
    file), the unprefixed GPT-2 layout and the extra-key corruption;
  * ``--device=cuda`` without a GPU raises.

``--train_step`` is held in tests/test_torch_verify_release_step.py and
``--fit`` in tests/test_torch_verify_release_fit.py (a file each, so that
no file of the fast tier takes much more than a minute).
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch

import vidsitu_tpu.verify_release as jvr
import vidsitu_tpu_torch.verify_release as pvr
from tests.test_verify_release import weights_dir  # noqa: F401 (fixture)
from vidsitu_tpu_torch.data.synth import make_release_tree

torch.set_num_threads(1)

LINE = re.compile(r"^\[(ok|FAIL|skip)\]\s+(.+?)(?::\s|$)")


def run_both(argv, capsys, tmp=None):
    """Both ``main``s on ``argv`` (the port's on the CPU); each one's exit
    code, ordered (status, check name) list and output. With ``tmp``, each
    writes its converted vocabs to its own ``tmp/{jax,port}``."""
    res = {}
    for tag, mod, extra in (("jax", jvr, []), ("port", pvr,
                                                ["--device=cpu"])):
        conv = ["--convert_out", str(tmp / tag)] if tmp else []
        rc = mod.main([*argv, *conv, *extra])
        out = capsys.readouterr().out
        checks = [m.groups() for m in map(LINE.match, out.splitlines()) if m]
        res[tag] = (rc, checks, out)
    return res


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    make_release_tree(root, with_frames=True, frame_hw=64)
    return root


def _copy(release, dst):
    """The release without its frames, which the copy links to."""
    shutil.copytree(release, dst, ignore=shutil.ignore_patterns(
        "vsitu_frames", "converted*"))
    (dst / "vsitu_frames").symlink_to(release / "vsitu_frames")
    return dst


def test_release_tree_same_checks_and_converted_files(release, tmp_path,
                                                      capsys):
    res = run_both(["--dir", str(release)], capsys, tmp_path)
    (jrc, jchecks, jout), (prc, pchecks, pout) = res["jax"], res["port"]
    assert jrc == prc == 0, pout
    assert pchecks == jchecks, (pchecks, jchecks)
    names = [n for _, n in pchecks]
    assert "debug epoch[vb/sf_base]" in names and len(names) > 20
    jfiles, pfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert {"verb_id_vocab.json"} < set(pfiles) and any(
        k.startswith("bpe_with_seps_vb_arg_vocab/") for k in pfiles)
    assert pfiles == jfiles


def _drop_ev3(root):
    ann = root / "vidsitu_annotations" / "vseg_ann_files" / \
        "vsann_valid_lb.json"
    lst = json.loads(ann.read_text())
    del lst[0]["Ev3"]
    ann.write_text(json.dumps(lst))


def _drop_verb_vocab(root):
    (root / "vsitu_vocab" / "verb_id_vocab.pkl").unlink()


def _truncate_vinfo(root):
    vp = root / "vidsitu_annotations" / "vinfo_files" / "vinfo_valid_lb.json"
    text = vp.read_text()
    vp.write_text(text[:len(text) // 2])


CORRUPTIONS = {
    "ann_missing_event": (_drop_ev3, ["ann[valid]"]),
    "missing_verb_vocab": (_drop_verb_vocab, ["verb_id_vocab.pkl"]),
    "truncated_vinfo": (_truncate_vinfo, ["vinfo[valid]"]),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_fails_the_same_checks(release, tmp_path, capsys, case):
    corrupt, want = CORRUPTIONS[case]
    bad = _copy(release, tmp_path / "bad")
    corrupt(bad)
    res = run_both(["--dir", str(bad), "--no_epoch"], capsys, tmp_path)
    (jrc, jchecks, _), (prc, pchecks, pout) = res["jax"], res["port"]
    assert prc == jrc == len(want), pout
    assert pchecks == jchecks
    assert [n for s, n in pchecks if s == "FAIL"] == want


# -- --weights ----------------------------------------------------------------
def _same_weights_checks(res):
    (jrc, jchecks, _), (prc, pchecks, pout) = res["jax"], res["port"]
    assert prc == jrc, pout
    assert pchecks == jchecks
    return pchecks, pout


def test_weights_sweep_same_statuses(weights_dir, capsys):  # noqa: F811
    checks, out = _same_weights_checks(
        run_both(["--weights", str(weights_dir)], capsys))
    assert ("skip", "weights[unknown.pt]") in checks
    assert {("ok", "weights[gpt2/pytorch_model.bin]"),
            ("ok", "weights[roberta/pytorch_model.bin]"),
            ("ok", "weights[SLOWFAST_8x8_R50.pkl]"),
            ("ok", "weights[vb_slow_fast_nl_r50_8x8_model.pth]")} < set(checks)
    assert out.count("loaded into the port's model (strict)") == 2
    assert "logits == torch/HF" in out and "hidden states == torch/HF" in out


def test_weights_sweep_unprefixed_gpt2(weights_dir, tmp_path,  # noqa: F811
                                       capsys):
    """The hub layout of gpt2 / gpt2-medium: backbone keys unprefixed."""
    from transformers import GPT2Config, GPT2LMHeadModel

    gdir = tmp_path / "gpt2_hub"
    gdir.mkdir()
    gcfg = GPT2Config(vocab_size=97, n_positions=32, n_embd=32, n_layer=2,
                      n_head=2, resid_pdrop=0.0, embd_pdrop=0.0,
                      attn_pdrop=0.0)
    torch.manual_seed(4)
    torch.save(GPT2LMHeadModel(gcfg).eval().transformer.state_dict(),
               gdir / "pytorch_model.bin")
    (gdir / "config.json").write_text(gcfg.to_json_string())
    checks, _ = _same_weights_checks(
        run_both(["--weights", str(tmp_path)], capsys))
    assert checks == [("ok", "weights[gpt2_hub/pytorch_model.bin]")]


def test_weights_sweep_catches_corruption(weights_dir, tmp_path,  # noqa: F811
                                          capsys):
    bad = tmp_path / "badw"
    shutil.copytree(weights_dir / "gpt2", bad / "gpt2")
    sd = torch.load(bad / "gpt2" / "pytorch_model.bin", weights_only=True)
    sd["transformer.h.2.ln_1.weight"] = torch.zeros(32)
    torch.save(sd, bad / "gpt2" / "pytorch_model.bin")
    res = run_both(["--weights", str(bad)], capsys)
    checks, out = _same_weights_checks(res)
    assert res["port"][0] == 1
    assert checks == [("FAIL", "weights[gpt2/pytorch_model.bin]")]
    assert "h.2" in out


def test_weights_without_transformers_fail_alike(weights_dir,  # noqa: F811
                                                 monkeypatch, capsys):
    """Where ``transformers`` cannot be imported, both packages fail the
    GPT-2 and RoBERTa spot-checks with the import error on their
    ``[FAIL]`` lines and still run the video checks."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    res = run_both(["--weights", str(weights_dir)], capsys)
    checks, out = _same_weights_checks(res)
    assert res["port"][0] == 2
    assert [n for s, n in checks if s == "FAIL"] == [
        "weights[gpt2/pytorch_model.bin]",
        "weights[roberta/pytorch_model.bin]"]
    fails = [ln for ln in out.splitlines() if ln.startswith("[FAIL]")]
    assert all("ModuleNotFoundError" in ln and "transformers" in ln
               for ln in fails), fails
    assert ("ok", "weights[SLOWFAST_8x8_R50.pkl]") in checks


def test_sfbase_loads_into_the_port_model_strictly(weights_dir):  # noqa: F811
    """The trained SFBase .pth: converted, loaded with strict=True, every
    tensor of the port's model equal to the checkpoint's."""
    from vidsitu_tpu_torch.convert.hf_torch import load_torch_state_dict
    from vidsitu_tpu_torch.convert.slowfast_torch import (
        convert_sfbase_checkpoint,
    )

    path = weights_dir / "vb_slow_fast_nl_r50_8x8_model.pth"
    sd = load_torch_state_dict(str(path))
    model = pvr.load_video_tree(
        convert_sfbase_checkpoint(sd, arch="slowfast", strict=True),
        "slowfast")
    ours = model.state_dict()
    assert torch.equal(ours["proj_head.layers_1.weight"], torch.from_numpy(
        sd["module.proj_head.2.weight"]))
    w = sd["module.sf_mdl.s2.pathway0_res0.branch2.b.weight"]
    assert torch.equal(ours["backbone.s2_slow.block_0.b.conv.weight"],
                       torch.from_numpy(w))
    # a tree that does not fit the model fails the strict load
    tree = convert_sfbase_checkpoint(sd, arch="slowfast", strict=True)
    tree["params"]["backbone"]["s2_slow"]["block_0"]["extra"] = {
        "bias": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        pvr.load_video_tree(tree, "slowfast")


def test_cuda_without_a_gpu_raises(release, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--dir", str(release)], ["--fit"], ["--weights", "x"]):
        with pytest.raises(RuntimeError, match="is_available"):
            pvr.main(argv)
        with pytest.raises(RuntimeError, match="is_available"):
            pvr.main([*argv, "--device=cuda"])


@pytest.mark.parametrize("arch", ["slowfast", "i3d"])
def test_pysf_layout_round_trips_through_the_checks(arch):
    """convert/to_pyslowfast.py (phase 27's checkpoint writer) inverts
    convert/slowfast_torch.py: a seeded SFBase (SlowFast at depth 26, or an
    I3D with non-local blocks) written in that layout converts strictly
    and loads back into the port's model equal to itself."""
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.convert.slowfast_torch import (
        convert_sfbase_checkpoint,
    )
    from vidsitu_tpu_torch.convert.to_pyslowfast import pysf_state_dict
    from vidsitu_tpu_torch.models.vb_models import VbVideoModel
    from vidsitu_tpu_torch.models.video_backbone import VideoCfg

    nl = ((), ((1,),), ((1,),), ()) if arch == "i3d" else ((), (), (), ())
    vid = VideoCfg(arch=arch, depth_blocks=(1, 2, 2, 1) if arch == "i3d"
                   else (1, 1, 1, 1), nl_location=tuple(
                       tuple(st) if st else ((),) for st in nl))
    model = VbVideoModel(vid, num_classes=7)
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 5)),
                          strict=True)
    sd = pysf_state_dict(model.state_dict())
    assert all(k.startswith(("module.sf_mdl.", "module.proj_head."))
               for k in sd)
    tree = convert_sfbase_checkpoint({k: v.numpy() for k, v in sd.items()},
                                     arch, strict=True)
    loaded = pvr.load_video_tree(tree, arch).state_dict()
    want = model.state_dict()
    assert loaded.keys() == want.keys()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded[k], v), k
