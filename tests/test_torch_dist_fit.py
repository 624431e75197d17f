"""The port's several-process training engine on 2 gloo ranks on the CPU
(tests/torch_dist_child.py): SRL fits at tiny widths through
``python -m vidsitu_tpu_torch.main`` with dropout on, and the
``parallel/`` helpers.

  * a 2-epoch fit and a resumed third equal a straight 3-epoch fit bit for
    bit, each rank's dropout generator restored from the checkpoint (the
    two ranks draw other masks); a resume on 1 process of that checkpoint
    raises;
  * SIGTERM sent by rank 1 to itself as its second train step starts: both
    ranks finish the epoch, one preempt checkpoint holds both ranks'
    generators, both exit 0;
  * ``reduce_dict`` / ``reduce_dict_corr`` in float64 (the JAX package's
    gather drops to float32: 1 + 2**-40 would come back as 1),
    ``broadcast_object``, ``all_gather_object`` and the ``data`` mesh;
  * ``--device=cuda`` on a LOCAL_RANK beyond the host's cards and an
    ``fsdp`` / ``model`` mesh axis raise; so does the evaluators' merge
    when the run token's broadcast fails (the JAX package falls back to a
    per-rank token, evaluators.py:118-124, and its merge then waits for
    markers that never come).
"""

import pytest
import torch

from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import launch
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.evaluation import evaluators as E
from vidsitu_tpu_torch.parallel import collectives as C
from vidsitu_tpu_torch.parallel import mesh as M
from vidsitu_tpu_torch.train.build import build_learner
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_fit")
    paths = make_synth_dataset(root / "data", n_train=8, n_valid=3, n_test=1,
                               seed=31)
    kv = {**paths, **SRL_TINY, "task_type": "vb_arg",
          "mdl.mdl_name": "sfpret_txe_txd_vbarg", "train.dtype": "float32",
          "train.bs": 4, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
          "gen.max_len_b": 6, "train.lr": 1e-3, "run_final_val": False,
          "train.save_mdl_epochs": True, "misc.tmp_path": str(root / "tmp")}
    return root, kv


def _argv(kv, uid, *extra):
    return [uid, *[f"--{k}={v}" for k, v in kv.items()], "--device=cpu",
            *extra]


def _ckpt(root, uid, epoch):
    return torch.load(root / "tmp" / "model_epochs" / uid
                      / f"mdl_ep_{epoch}.ckpt", weights_only=True)


def test_resumed_epoch_equals_straight_fit_bitwise(env):
    root, kv = env
    ep2 = root / "tmp" / "model_epochs" / "two" / "mdl_ep_2.ckpt"
    outs, _ = launch("main", {"runs": [
        _argv(kv, "three", "--train.epochs=3"),
        _argv(kv, "two", "--train.epochs=2"),
        _argv(kv, "two", "--train.epochs=1", "--train.resume=True",
              f"--train.resume_path={ep2}")]}, root / "resume")
    for out in outs:
        assert [(r["num_epoch"], r["num_it"]) for r in out["runs"]] == [
            (3, 6), (2, 4), (3, 6)]
        assert torch.equal(out["runs"][0]["dropout_rng"],
                           out["runs"][2]["dropout_rng"])
    straight, resumed = _ckpt(root, "three", 3), _ckpt(root, "two", 3)
    assert straight["world_size"] == resumed["world_size"] == 2
    for k, v in straight["model_state_dict"].items():
        assert torch.equal(resumed["model_state_dict"][k], v), k
    rngs = straight["dropout_rng_by_rank"]
    assert len(rngs) == 2 and not torch.equal(rngs[0], rngs[1])
    for r in range(2):
        assert torch.equal(resumed["dropout_rng_by_rank"][r], rngs[r])
        assert torch.equal(outs[r]["runs"][0]["dropout_rng"], rngs[r])
    # one process resumes what two wrote: the weights, the counters and
    # rank 0's dropout generator, and says so in the log
    cfg = get_cfg_with_overrides("two", **{
        **kv, "train.resume": True, "train.resume_path": str(ep2)})
    one = build_learner(cfg, "two", "cpu")
    saved = torch.load(ep2, weights_only=True)
    assert (one.num_epoch, one.num_it) == (2, 4)
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, saved["model_state_dict"][k]), k
    assert torch.equal(one.dropout_gen.get_state(),
                       saved["dropout_rng_by_rank"][0])
    assert "resumed a 2-process checkpoint on 1 processes" in (
        one.txt_log_file.read_text())


def test_sigterm_to_one_rank_saves_once_and_both_exit_zero(env):
    """Rank 1 signals itself as its train step 2 (of 2 an epoch) starts:
    the flag is OR-ed at the epoch boundary, both ranks save the preempt
    checkpoint together (rank 0 writes it) and return; the launch's exit
    code 0 is both ranks'."""
    root, kv = env
    outs, _ = launch("main", {"runs": [_argv(kv, "pre", "--train.epochs=5")],
                              "kill_rank": 1, "kill_at_it": 1},
                     root / "preempt")
    for out in outs:
        (run,) = out["runs"]
        assert run["preempted"] and (run["num_epoch"], run["num_it"]) == (0, 2)
    models = root / "tmp" / "models"
    saved = torch.load(models / "pre.preempt.ckpt", weights_only=True)
    assert saved["num_it"] == 2 and saved["world_size"] == 2
    for r in range(2):
        assert torch.equal(saved["dropout_rng_by_rank"][r],
                           outs[r]["runs"][0]["dropout_rng"])
    assert not (models / "pre.ckpt").exists()
    log = (root / "tmp" / "txt_logs" / "pre.txt").read_text()
    assert log.count("preempted at epoch 0 it 2") == 1


def test_collectives_reduce_in_float64_over_two_ranks(tmp_path):
    tiny = 2.0 ** -40
    vals = [{"a": 1.0, "b": 3.0}, {"a": 1.0 + tiny, "b": -1.0}]
    outs, _ = launch("collectives", {"values": vals, "nums": [1, 3]},
                     tmp_path)
    for r, out in enumerate(outs):
        assert (out["rank"], out["world"], out["main"]) == (r, 2, r == 0)
        assert out["sum"] == {"a": 2.0 + tiny, "b": 2.0}
        assert out["mean"] == {"a": 1.0 + tiny / 2, "b": 1.0}
        assert out["corr"] == {"a": 1.0 + 3 * tiny / 4, "b": 0.0}
        assert out["bcast"] == {"rank": 0, "x": 1.0}
        assert out["gather"] == [1.0, 1.0 + tiny]
        assert out["mesh"] == [2, ["data"]]


def test_one_process_without_torchrun(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_distributed("cpu") == torch.device("cpu")
    assert not C.is_dist() and C.get_world_size() == 1
    assert C.reduce_dict({"a": 1.5}) == {"a": 1.5}
    assert C.broadcast_object("x") == "x"
    assert C.all_gather_object(3) == [3]


def test_cuda_rank_beyond_the_host_cards_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 but this host has 2"):
        M.init_distributed("cuda")
    assert not C.is_dist()
    assert M.rank_device("cuda:0", 2) == torch.device("cuda", 0)
    assert M.rank_device("cuda", 1) == torch.device("cuda", 1)


@pytest.mark.parametrize("axes", [["data", "fsdp"], ["data", "model"]])
def test_fsdp_and_model_axes_raise(axes, tmp_path):
    cfg = get_cfg_with_overrides("t", **{"tpu.mesh_axis_names": str(axes),
                                         "tpu.mesh_shape": "[-1, 2]"})
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        M.make_mesh(cfg)


def test_merge_raises_when_the_token_broadcast_fails(monkeypatch, tmp_path):
    def broken(obj, src=0):
        raise RuntimeError("broadcast failed")

    monkeypatch.setattr(E, "broadcast_object", broken)
    ev = E._RankedEvaluator(rank=1, world_size=2)
    with pytest.raises(RuntimeError, match="broadcast failed"):
        ev._merge_ranks(tmp_path, "valid", [{"ann_idx": 0}])
    assert not list(tmp_path.glob(".valid_*.done"))
