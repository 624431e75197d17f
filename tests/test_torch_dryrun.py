"""The port's entry points of a dry run (``vidsitu_tpu_torch/dryrun.py``, the
counterpart of the root ``__graft_entry__.py``) on the CPU: ``entry``'s
forward, and ``dryrun_multichip(4)`` over 4 gloo ranks, every assertion of
the JAX entry at its limits, one line a part in its wording."""

import math
import re

import pytest
import torch

from vidsitu_tpu_torch import dryrun

torch.set_num_threads(1)


def test_entry_runs_one_forward():
    fn, (model, batch) = dryrun.entry(device="cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"
    assert batch["seq_out_by_ev"].shape[:2] == (2, 5)
    loss = fn(model, batch)
    assert loss.dim() == 0 and math.isfinite(loss.item())


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    return dryrun.dryrun_multichip(4, device="cpu")


# the JAX entry's lines (MULTICHIP_r05.json), with this run's meshes
WANT = [
    r"dryrun\[vb_arg/sfpret_txe_txd_vbarg\] OK loss_4dev=\S+ loss_1dev=\S+ "
    r"max_param_delta=\S+ extra_leaves=0 mesh=\{'data': 2, 'fsdp': 2\}",
    r"dryrun\[vb_arg tp\] OK tensor-parallel mesh \{'data': 2, 'model': 2, "
    r"'fsdp': 1\} loss=\S+ == 1dev",
    r"dryrun\[vb_arg decode\] OK segmented ancestry beam-3 4dev == 1dev "
    r"\(tokens exact\)",
    r"dryrun\[vb/sf_base\] OK loss_4dev=\S+ loss_1dev=\S+ max_param_delta=\S+"
    r" extra_leaves=\d+ mesh=\{'data': 2, 'fsdp': 2\}",
    r"dryrun\[evrel/sfpret_evrel\] OK loss_4dev=\S+ loss_1dev=\S+ "
    r"max_param_delta=\S+ extra_leaves=0 mesh=\{'data': 2, 'fsdp': 2\}",
    r"dryrun\[extract\] OK sharded clip-stream 4dev == 1dev \(5 segments, "
    r"spanning batches \+ padded tail\)",
    r"dryrun\[elastic\] OK save@\{'data': 2, 'fsdp': 2\} -> "
    r"resume@\{'data': 2\}: continued loss \S+ == uninterrupted \S+",
    r"dryrun_multichip\(4\) OK: vb_arg\+vb\+evrel verified",
]


@pytest.mark.parametrize("i", range(len(WANT)))
def test_dryrun_multichip_prints_every_jax_line(dry, i):
    assert len(dry) == len(WANT), dry
    assert re.fullmatch(WANT[i], dry[i]), dry[i]


def test_dryrun_losses_agree(dry):
    """The printed n-rank and one-process losses of each task agree to the
    5 decimals printed; the vb task's BatchNorm statistics were held
    (its 76 statistics leaves)."""
    for line in dry[:5]:
        m = re.search(r"loss_4dev=(\S+) loss_1dev=(\S+)", line)
        if m:
            assert m.group(1) == m.group(2), line
    assert "extra_leaves=76" in dry[3]


def test_plan_meshes():
    """Ranks sharing one card through gloo take no fsdp axis (FSDP2 cannot
    run there) and a [n/2, 2] tensor-parallel mesh; the CPU takes the JAX
    entry's meshes."""
    cpu = dryrun._plan(4, "cpu")
    assert cpu["backend"] == "gloo" and not cpu["shared"]
    assert cpu["dp"] == ([2, 2], ["data", "fsdp"])
    assert cpu["tp"] == ([2, 2, 1], ["data", "model", "fsdp"])
    assert cpu["small"] == ([2], ["data"])
    assert dryrun._plan(3, "cpu")["dp"] == ([3], ["data"])
    assert dryrun._plan(2, "cpu")["tp"] is None
    # one card named: the ranks share it through gloo
    shared = dryrun._plan(2, "cuda:0")
    assert shared["backend"] == "gloo" and shared["shared"]
    assert shared["dp"] == ([2], ["data"])
    assert shared["tp"] == ([1, 2], ["data", "model"])
