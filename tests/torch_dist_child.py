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
    overrides and each step's batch for every data coordinate), a
    ``Learner`` on this rank's batches (its model split first when the
    overrides name a ``model`` mesh axis, then sharded when they name an
    ``fsdp`` axis), optionally resuming a checkpoint first and saving one
    after, optionally validating after (SRL decoding through ``EvalB_Gen``
    with a counting stand-in for the row gather); the global losses, the
    gradients the update used, the state dict after the steps (whole
    tensors) and the dropout generator's states (``whole_on_rank0``: the
    gradients and the state dict on rank 0 only, the other ranks' being the
    same gathered tensors); then, for each ``builds`` entry, the error
    ``build_learner`` raises on its overrides, and with ``modules`` the
    split attention and FFN modules' outputs and gradients;
  * ``main``: ``vidsitu_tpu_torch.main.main(argv)`` for each argv in turn,
    in the one process group; optionally SIGTERM sent by one rank to itself
    when its train step ``kill_at_it`` starts, or one rank's SRL beam search
    cut to 2 steps in one run (``short_decode``: the ranks then decode
    different numbers of steps);
  * ``extract``: ``vidsitu_tpu_torch.extract.main(argv)``;
  * ``collectives``: ``parallel.collectives`` and ``parallel.mesh`` on
    float64 values that float32 cannot hold;
  * ``mesh``: the mesh of ``spec["cfg"]``'s axes and this rank's data and
    model groups;
  * ``fit``: for each case file, ``Learner.fit`` of the case's whole model
    placed on the run's mesh as ``build_learner`` places one, on this
    rank's loader shard, validated each epoch, optionally resuming a
    checkpoint first and optionally resized (``Learner.request_resize``)
    at the first epoch boundary; a resize that took place ends the launch
    (the ranks that left take part in nothing after it).
"""

import contextlib
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


def attention_f64(q, k, v, kind, scale):
    """The plain attention of ``ops.attention.attention_reference`` in the
    inputs' dtype (that one computes in float32, as the JAX package's); a
    model that a case file holds may name it, so it lives here."""
    logits = torch.bmm(q, k.transpose(1, 2))
    probs = (torch.softmax(logits * scale, dim=-1) if kind == "softmax"
             else logits / logits.shape[-1])
    return torch.bmm(probs, v)


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def whole(t):
    """A DTensor gathered whole (a collective), a tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def run_case(case, rank, tmp):
    """One case of mode ``steps`` on this rank (also called in the test's
    own process, rank 0 of one): a ``Learner`` that optionally resumes a
    checkpoint (``resume``, optimizer included) before its steps, saves one
    (``save``) after them and validates (``validate``, see
    :func:`validate_case`); every step ticks ``num_it`` as an epoch's steps
    do, on the batch of this rank's data coordinate. ``divide`` sets
    FSDP2's gradient divide factor of every wrapped module but the root
    back to this value (a control); ``local_masks`` has each split module
    draw a dropout mask of its own slice's shape rather than its slice of
    the whole mask (a control)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from vidsitu_tpu_torch.parallel.mesh import make_mesh, shard_model
    from vidsitu_tpu_torch.parallel.tensor import shard_tp
    from vidsitu_tpu_torch.train.learner import Learner
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    model = case["model"]
    cfg = get_cfg_with_overrides("t", **{"misc.tmp_path": tmp,
                                         **case["cfg"]})
    layout = None
    axes = cfg.tpu.mesh_axis_names
    split = None
    if "model" in axes or "fsdp" in axes:
        mesh = make_mesh(cfg)
        split = shard_tp(model, mesh)
    local_shapes = {n: list(p.shape) for n, p in model.named_parameters()}
    if "fsdp" in axes:
        shard_model(model, mesh)
        if case.get("divide"):
            for m in model.modules():
                if isinstance(m, FSDPModule) and m is not model:
                    m.set_gradient_divide_factor(float(case["divide"]))
        p0 = next(model.parameters())
        layout = {"mesh": list(mesh.mesh.shape), "placements": {
            n: [str(pl) for pl in p.placements]
            for n, p in model.named_parameters()},
            "local_rows": {n: p.to_local().shape[0] if p.dim() else 0
                           for n, p in model.named_parameters()},
            "first": str(type(p0).__name__)}
    learner = Learner("t", cfg, model, None, None, "cpu")
    learner.prepare_optimizer(case["lr"])
    rng_loaded = None
    if case.get("resume"):
        learner.load_model_dict(case["resume"], load_opt=True)
        rng_loaded = learner.dropout_gen.get_state()
    grads = {}
    step = learner.optimizer.step
    if layout is not None:
        # the Learner and its optimizer hold the sharded parameters
        opt_params = learner.optimizer.param_groups[0]["params"]
        layout["learner_params_sharded"] = (
            all(isinstance(p, DTensor) for p in learner._params)
            and len(opt_params) == len(learner._params)
            and all(a is b for a, b in zip(opt_params, learner._params)))

    def keep_grads_then_step(step=step, grads=grads, model=model):
        grads.update({n: learner._whole(n, torch.zeros_like(p) if p.grad
                                        is None else p.grad.clone(), True)
                      for n, p in model.named_parameters()})
        step()

    learner.optimizer.step = keep_grads_then_step
    losses = []
    with local_masks(case.get("local_masks")):
        for per_rank in case["batches"]:
            losses.append(float(learner.train_step(
                to_torch(per_rank[learner.data_rank]))))
            learner.num_it += 1
    if case.get("save"):
        learner.save_model_dict(case["save"])
        learner.ckpt_backend.wait()
    out = {"losses": losses, "grads": grads,
           "state_dict": {k: learner._whole(k, v, True).clone() for k, v in
                          model.state_dict().items()},
           "num_it": learner.num_it, "rng_loaded": rng_loaded,
           "rng": learner.dropout_gen.get_state(), "layout": layout,
           "accum_count": learner._accum_count,
           "local_shapes": local_shapes,
           "split_dims": split.dims if split else {}}
    if case.get("validate"):
        out["validate"] = validate_case(learner, cfg, model)
    return out


@contextlib.contextmanager
def local_masks(on):
    """With ``on``, ``models.common.dropout`` ignores ``split``: each rank
    draws a mask of its slice's shape."""
    from vidsitu_tpu_torch.models import common

    plain = common.dropout
    if on:
        common.dropout = (lambda x, rate, training, split=None:
                          plain(x, rate, training))
    try:
        yield
    finally:
        common.dropout = plain


def validate_case(learner, cfg, model):
    """SRL validation of the case's model wired as ``build_learner`` wires
    it: this rank's loader shard by data coordinate, ``EvalB_Gen`` over the
    model's generator, ``Learner.validate``. A counting stand-in for the
    row gather records each reorder's leaves and heads. Returns the
    metrics, the decode steps, the reorders and their heads, and rank 0's
    merged pickle."""
    import pickle

    from vidsitu_tpu_torch.data import get_data
    from vidsitu_tpu_torch.evaluation.evaluators import EvalB_Gen
    from vidsitu_tpu_torch.gen import beam
    from vidsitu_tpu_torch.models.selector import build_srl_generate_fn

    data = get_data(cfg, num_shards=C.data_world_size(),
                    shard_id=C.data_rank())
    comm = data.valid_dl.dataset.comm
    gen = build_srl_generate_fn(cfg, comm, model)
    learner.data = data
    learner.eval_fn = EvalB_Gen(cfg, comm, gen, "cpu", rank=C.data_rank(),
                                world_size=C.data_world_size(),
                                model_rank=C.model_rank())
    heads, plain = [], beam.gather_rows

    def counting(leaves, rows):
        heads.append(sorted({x.shape[1] for x in leaves if x.dim() == 4}))
        return plain(leaves, rows)

    beam.gather_rows = counting
    try:
        loss, acc, _ = learner.validate()
    finally:
        beam.gather_rows = plain
    pkl = learner.predictions_dir / "valid_0.pkl"
    pred = None
    if C.get_rank() == 0:
        with open(pkl, "rb") as f:
            pred = pickle.load(f)
    return {"acc": acc, "steps": gen.steps, "gathers": len(heads),
            "heads": heads, "pred": pred}


def modules_check(spec):
    """The split attention and FFN modules of ``spec`` (float64, seeded,
    dropout on) on this rank: their outputs, the input's gradient and the
    parameters' gradients gathered whole, and ``reduce_from_model`` /
    ``copy_to_model`` on a tensor of this rank's value."""
    from vidsitu_tpu_torch.models import common
    from vidsitu_tpu_torch.parallel import tensor as T
    from vidsitu_tpu_torch.parallel.mesh import make_mesh
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    res = {}
    mesh = make_mesh(get_cfg_with_overrides("t", **spec["cfg"]))
    for name, path in spec["cases"].items():
        case = torch.load(path, weights_only=False)
        mod, x = case["module"], case["x"].clone().requires_grad_(True)
        split = T.shard_tp(mod, mesh)
        mod.train()
        with common.dropout_generator(torch.Generator().manual_seed(5)):
            y = mod(*([x, x] if case["attention"] else [x]))
            y = y[0] if isinstance(y, tuple) else y
        (y * case["dy"]).sum().backward()
        res[name] = {"y": y.detach(), "dx": x.grad,
                     "heads": getattr(mod, "n_heads", None),
                     "grads": {n: split.whole(n, p.grad)
                               for n, p in mod.named_parameters()}}
    v = torch.full((3,), float(C.get_rank() + 1), dtype=torch.float64,
                   requires_grad=True)
    fwd = T.reduce_from_model(v * 1.0)
    (fwd * torch.arange(3.0, dtype=torch.float64)).sum().backward()
    w = torch.full((3,), 2.0, dtype=torch.float64, requires_grad=True)
    (T.copy_to_model(w) * float(C.get_rank() + 1)).sum().backward()
    res["reduce"] = {"fwd": fwd.detach(), "grad": v.grad}
    res["copy"] = {"grad": w.grad}
    return res


def fit_case(case, tmp):
    """One case of mode ``fit`` on this rank (also called in the test's own
    process, without a process group): the case's whole model placed on
    this run's mesh by ``train.build.place_model``, this rank's loader
    shard, ``EvalB`` (task ``vb``) or ``EvalB_Gen`` with a counting
    stand-in for the row gather, a ``Learner`` that optionally resumes
    ``resume`` (optimizer included), tries a grow (``grow``: the error it
    raises) and requests a resize to ``resize`` ranks, then fits ``epochs``
    epochs. ``drop_adam`` has the resize leave Adam's state out (a
    control). Returns the global step losses, each validation's metrics,
    the row gathers by epoch, what the resize saw, the error ``fit``
    raised, and on the ranks of the run after it the state dict (whole
    tensors), the counters, the dropout generator's state and rank 0's txt
    log."""
    from vidsitu_tpu_torch.data import get_data
    from vidsitu_tpu_torch.evaluation.evaluators import EvalB, EvalB_Gen
    from vidsitu_tpu_torch.gen import beam
    from vidsitu_tpu_torch.models.selector import build_srl_generate_fn
    from vidsitu_tpu_torch.parallel.mesh import make_mesh
    from vidsitu_tpu_torch.train.build import place_model
    from vidsitu_tpu_torch.train.learner import Learner
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    name = case["name"]
    cfg = get_cfg_with_overrides(name, **{"misc.tmp_path": tmp,
                                          **case["cfg"]})
    dev = torch.device("cpu")
    mesh = make_mesh(cfg) if C.is_dist() else None
    model, eval_model = place_model(case["model"], cfg, mesh, dev)
    data = get_data(cfg, num_shards=C.data_world_size(),
                    shard_id=C.data_rank())
    comm = data.valid_dl.dataset.comm
    ranks = dict(rank=C.data_rank(), world_size=C.data_world_size(),
                 model_rank=C.model_rank())
    if cfg.task_type == "vb":
        evalb = EvalB(cfg, comm, eval_model, dev, **ranks)
    else:
        evalb = EvalB_Gen(cfg, comm, build_srl_generate_fn(
            cfg, comm, eval_model), dev, **ranks)
    learner = Learner(name, cfg, model, data, evalb, dev,
                      eval_model=eval_model, mesh=mesh)
    if case.get("resume"):
        learner.load_model_dict(case["resume"], load_opt=True)
    out = {"error": None, "grow": None}
    if case.get("grow"):
        try:
            learner.request_resize(case["grow"])
        except ValueError as e:
            out["grow"] = str(e)
    if case.get("resize"):
        learner.request_resize(case["resize"])
    losses, metrics, gathers, at_resize = [], [], [], {}
    step, validate = learner.train_step, learner.validate
    apply, restore = learner._apply_resize, learner._restore_opt

    def train_step(batch):
        loss = step(batch)
        losses.append(float(loss))
        return loss

    def validate_and_keep(*a, **kw):
        res = validate(*a, **kw)
        metrics.append(res[1])
        return res

    def apply_resize():
        at_resize.update(accum_count=learner._accum_count,
                         num_epoch=learner.num_epoch,
                         world=learner.world_size, steps=decode_steps())
        if case.get("drop_adam"):
            learner._restore_opt = lambda pending: restore(
                {**pending, "opt": {**pending["opt"], "state": {}}})
        return apply()

    def decode_steps():
        gen = getattr(learner.eval_fn, "generate_fn", None)
        return list(gen.steps) if gen is not None else None

    def counting(leaves, rows):
        gathers.append((learner.num_epoch,
                        sorted({x.shape[1] for x in leaves if x.dim() == 4})))
        return plain(leaves, rows)

    learner.train_step, learner.validate = train_step, validate_and_keep
    learner._apply_resize = apply_resize
    plain, beam.gather_rows = beam.gather_rows, counting
    try:
        learner.fit(case["epochs"], case["lr"])
    except Exception as e:  # noqa: BLE001 - the test reads it
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        beam.gather_rows = plain
    out.update(losses=losses, metrics=metrics, gathers=gathers,
               at_resize=at_resize, left=learner.left, steps=decode_steps(),
               resized=learner._resized)
    if learner.left:
        return out
    out.update(
        state_dict={k: learner._whole(k, v, True).clone()
                    for k, v in learner.model.state_dict().items()},
        num_it=learner.num_it, num_epoch=learner.num_epoch,
        world=C.get_world_size(), data=[learner.data_rank, learner.data_world],
        mesh=learner._mesh_shape(), sharded=learner.sharded,
        split=sorted(learner.split.dims) if learner.split else [],
        rng=learner.dropout_gen.get_state(),
        log=(learner.txt_log_file.read_text() if learner.is_main else None))
    return out


def mode_fit(spec, rank):
    out = {}
    for path in spec["cases"]:
        case = torch.load(path, weights_only=False)
        out[case["name"]] = res = fit_case(case, spec["tmp"])
        if res["resized"] or res["left"]:
            break
    return out


def mode_steps(spec, rank):
    out = {}
    for path in spec["cases"]:
        case = torch.load(path, weights_only=False)
        res = run_case(case, rank, spec["tmp"])
        if rank and spec.get("whole_on_rank0"):
            res.update(grads=None, state_dict=None)
        out[case["name"]] = res
    if spec.get("modules"):
        out["modules"] = modules_check(spec["modules"])
    for name, overrides in spec.get("builds", {}).items():
        # build_learner on this group: the error it raises, if any
        from vidsitu_tpu_torch.train.build import build_learner
        from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

        try:
            build_learner(get_cfg_with_overrides(name, **overrides), name,
                          "cpu")
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[name] = f"{type(e).__name__}: {e}"
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
    short = spec.get("short_decode") or {}
    if short.get("rank") == rank:
        from vidsitu_tpu_torch.gen import generate

        search = generate.beam_search

        def beam_search(*a, **kw):
            if len(runs) == short["run"]:
                kw["max_len"] = min(kw["max_len"], 2)
            return search(*a, **kw)

        generate.beam_search = beam_search
    runs = []
    for argv in spec["runs"]:
        res = pmain.main(argv)
        learner = res["learner"]
        runs.append({
            "results": {k: [dict(v[0]), dict(v[1])]
                        for k, v in res["results"].items()},
            "num_epoch": learner.num_epoch, "num_it": learner.num_it,
            "preempted": learner._preempt_requested,
            "dropout_rng": learner.dropout_gen.get_state(),
            "decode_steps": getattr(getattr(
                res["evaluator"], "generate_fn", None), "steps", None),
            "sharded": learner.sharded})
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


def mode_mesh(spec, rank):
    import torch.distributed as dist

    from vidsitu_tpu_torch.parallel.mesh import data_extent, make_mesh
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    mesh = make_mesh(get_cfg_with_overrides("t", **spec["cfg"]))

    def ranks(group):
        return dist.get_process_group_ranks(group) if group else None

    return {"shape": list(mesh.mesh.shape), "data_extent": data_extent(mesh),
            "data": [C.data_rank(), C.data_world_size(),
                     ranks(C.data_group())],
            "model": [C.model_rank(), C.model_world_size(),
                      ranks(C.model_group())]}


def main():
    mode, spec_path = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    init_distributed("cpu", "gloo", timeout_s=TIMEOUT_S)
    rank = C.get_rank()
    out = {"steps": mode_steps, "main": mode_main, "extract": mode_extract,
           "collectives": mode_collectives, "mesh": mode_mesh,
           "fit": mode_fit}[mode](
        spec, rank)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "vidsitu_tpu"))
    assert not leaked, f"rank {rank} imported {leaked[:5]}"
    torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")
    C.synchronize()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
