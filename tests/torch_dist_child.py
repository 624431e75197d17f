"""The rank program of the port's several-process tests
(tests/test_torch_dist_*.py)::

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        tests/torch_dist_child.py <mode> <spec.json>

Each rank joins a gloo process group on the CPU (with a timeout, so that a
collective that hangs fails the launch) and runs ``mode`` on what
``spec.json`` names, then writes ``{out}/rank{r}.pt``. It imports the port
and nothing of JAX: the tests compute the JAX references in their own
process and hand over the port's inputs as files.

Modes:
  * ``steps``: for each case file (``torch.save`` of the model, its config
    overrides and each step's batch for every rank), a ``Learner`` on this
    rank's batches; the global losses, the gradients the update used, and
    the state dict after the steps;
  * ``main``: ``vidsitu_tpu_torch.main.main(argv)`` for each argv in turn,
    in the one process group; optionally SIGTERM sent by one rank to itself
    when its train step ``kill_at_it`` starts;
  * ``extract``: ``vidsitu_tpu_torch.extract.main(argv)``;
  * ``collectives``: ``parallel.collectives`` and ``parallel.mesh`` on
    float64 values that float32 cannot hold.
"""

import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidsitu_tpu_torch.parallel import collectives as C  # noqa: E402
from vidsitu_tpu_torch.parallel.mesh import init_distributed  # noqa: E402

TIMEOUT_S = 60.0


def launch(mode, spec, tmp_path, nproc=2, timeout=240):
    """Run ``mode`` on ``nproc`` gloo ranks; every rank's output, in rank
    order. The launch has its own time limit: a rank that hangs fails the
    test (the whole process group of the launcher is killed)."""
    import subprocess

    out = Path(tmp_path) / f"{mode}_out"
    out.mkdir(parents=True, exist_ok=True)
    spec_path = Path(tmp_path) / f"{mode}_spec.json"
    spec_path.write_text(json.dumps({**spec, "out": str(out)}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", __file__, mode, str(spec_path)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{mode}: {nproc} ranks still running after "
                             f"{timeout} s\n{log[-4000:]}")
    assert proc.returncode == 0, f"{mode}: rc {proc.returncode}\n{log[-6000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nproc)], log


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def mode_steps(spec, rank):
    from vidsitu_tpu_torch.train.learner import Learner
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    out = {}
    for path in spec["cases"]:
        case = torch.load(path, weights_only=False)
        model = case["model"]
        cfg = get_cfg_with_overrides("t", **{
            "misc.tmp_path": spec["tmp"], **case["cfg"]})
        learner = Learner("t", cfg, model, None, None, "cpu")
        learner.prepare_optimizer(case["lr"])
        grads = {}
        step = learner.optimizer.step

        def keep_grads_then_step(step=step, grads=grads, model=model):
            grads.update({n: (torch.zeros_like(p) if p.grad is None
                              else p.grad.clone())
                          for n, p in model.named_parameters()})
            step()

        learner.optimizer.step = keep_grads_then_step
        losses = [float(learner.train_step(to_torch(per_rank[rank])))
                  for per_rank in case["batches"]]
        out[case["name"]] = {
            "losses": losses, "grads": grads,
            "state_dict": {k: v.clone() for k, v in
                           model.state_dict().items()}}
    return out


def mode_main(spec, rank):
    from vidsitu_tpu_torch import main as pmain
    from vidsitu_tpu_torch.train.learner import Learner

    kill_rank, kill_at = spec.get("kill_rank"), spec.get("kill_at_it")
    if kill_rank == rank:
        step = Learner.train_step

        def train_step(self, batch):
            if self.num_it == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(self, batch)

        Learner.train_step = train_step
    runs = []
    for argv in spec["runs"]:
        res = pmain.main(argv)
        learner = res["learner"]
        runs.append({
            "results": {k: [dict(v[0]), dict(v[1])]
                        for k, v in res["results"].items()},
            "num_epoch": learner.num_epoch, "num_it": learner.num_it,
            "preempted": learner._preempt_requested,
            "dropout_rng": learner.dropout_gen.get_state()})
    return {"runs": runs}


def mode_extract(spec, rank):
    from vidsitu_tpu_torch import extract

    extract.main(spec["argv"])
    return {}


def mode_collectives(spec, rank):
    from vidsitu_tpu_torch.parallel.mesh import data_extent, make_mesh
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    vals = spec["values"][rank]
    mesh = make_mesh(get_cfg_with_overrides("t"))
    return {
        "rank": C.get_rank(), "world": C.get_world_size(),
        "main": C.is_main_process(),
        "sum": C.reduce_dict(vals, average=False),
        "mean": C.reduce_dict(vals),
        "corr": C.reduce_dict_corr(vals, spec["nums"][rank]),
        "bcast": C.broadcast_object({"rank": rank, "x": vals["a"]}),
        "gather": C.all_gather_object(vals["a"]),
        "mesh": [data_extent(mesh), list(mesh.mesh_dim_names)],
    }


def main():
    mode, spec_path = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    init_distributed("cpu", "gloo", timeout_s=TIMEOUT_S)
    rank = C.get_rank()
    out = {"steps": mode_steps, "main": mode_main, "extract": mode_extract,
           "collectives": mode_collectives}[mode](spec, rank)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "vidsitu_tpu"))
    assert not leaked, f"rank {rank} imported {leaked[:5]}"
    torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")
    C.synchronize()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
