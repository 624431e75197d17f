"""The port stands alone: nothing under ``vidsitu_tpu_torch/`` and not
``chip_smoke.py`` imports ``vidsitu_tpu``, ``jax``, ``flax``, ``optax`` or
``orbax``; the port keeps its own copies of the host-side layers, and this
file keeps those copies equal to their originals (apart from a short
allow-list), so the two trees cannot drift unnoticed.
"""

import ast
import difflib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "vidsitu_tpu_torch"
JAX_PKG = REPO / "vidsitu_tpu"
BANNED = ("vidsitu_tpu", "jax", "jaxlib", "flax", "optax", "orbax")

# the copied sub-packages and, for each, the files copied
COPIED = {
    "utils": ["__init__.py", "config.py", "io.py", "misc.py", "box_utils.py"],
    "configs": sorted(
        str(p.relative_to(JAX_PKG / "configs"))
        for p in (JAX_PKG / "configs").rglob("*.y*ml")),
    "tokenization": ["__init__.py", "bpe.py", "tokenizer.py", "vocab.py",
                     "train_bpe.py", "import_hf.py"],
    "native": ["__init__.py", "bpe_core.cpp", "jpeg_core.cpp",
               "unicode_tables.h", "gen_unicode_tables.py"],
    "evaluation": ["evl_fns.py", "metrics/__init__.py", "metrics/bleu.py",
                   "metrics/cider.py", "metrics/coref.py", "metrics/meteor.py",
                   "metrics/rouge.py"],
    "data": ["__init__.py", "comm.py", "dataset.py", "frames.py", "loader.py",
             "pad.py", "synth.py"],
    "convert": ["tracking.py", "hf_torch.py", "slowfast_torch.py",
                "caffe2.py"],
    "train": ["tracking.py"],
    # top-level modules of the package
    ".": ["prep.py"],
}

# files allowed to differ from their original, with the most changed lines
# (added plus removed) and a word the changed lines must hold: the port's
# converter walks non-local modules by block index; prep's clip check takes
# a malformed container as invalid (the original lets count_frames'
# IndexError / KeyError / ValueError escape download_clip); three comments
# are reworded (one or two lines each, no code)
ALLOWED_DIFFS = {
    "./prep.py": (7, "malformed"),
    "convert/slowfast_torch.py": (16, "nonlocal"),
    "data/comm.py": (2, "Shared task metadata"),
    "data/frames.py": (4, "writers"),
    "native/__init__.py": (2, "read-only NFS"),
}


def _imported_roots(path: Path):
    """Top-level names of every absolute import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_banned_import_anywhere_in_the_port():
    files = _port_sources()
    assert len(files) > 40  # the scan really walks the package
    bad = [f"{p.relative_to(REPO)}:{line}: {root}"
           for p in files for root, line in _imported_roots(p)
           if root in BANNED]
    assert not bad, "\n".join(bad)
    # literal module names handed to importlib / __import__ are caught too
    dynamic = [str(p.relative_to(REPO)) for p in files
               if any(f'import_module("{b}' in p.read_text()
                      or f"__import__('{b}" in p.read_text() for b in BANNED)]
    assert not dynamic, dynamic


@pytest.mark.parametrize("sub", sorted(COPIED))
def test_subpackage_imports_nothing_banned(sub):
    files = [p for p in (PORT / sub).rglob("*.py")]
    if sub != "configs":
        assert files, f"no python file under {sub}"
    for p in files:
        roots = {r for r, _ in _imported_roots(p)}
        assert not roots & set(BANNED), (p, roots & set(BANNED))


@pytest.mark.parametrize("sub", sorted(COPIED))
def test_copied_files_equal_their_originals(sub):
    assert COPIED[sub], sub
    for rel in COPIED[sub]:
        src, dst = JAX_PKG / sub / rel, PORT / sub / rel
        assert dst.is_file(), f"{dst.relative_to(REPO)} is missing"
        a, b = src.read_text(), dst.read_text()
        key = f"{sub}/{rel}"
        if key not in ALLOWED_DIFFS:
            assert a == b, f"{key} differs from vidsitu_tpu/{key}"
            continue
        limit, word = ALLOWED_DIFFS[key]
        changed = [ln for ln in difflib.unified_diff(
            a.splitlines(), b.splitlines(), lineterm="", n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        assert 0 < len(changed) <= limit, (key, len(changed))
        body = "\n".join(changed)
        assert word in body, (key, body)
        assert body.count("import") <= 1  # the walk needs `re`, nothing else


def test_allow_list_names_only_copied_files():
    for key in ALLOWED_DIFFS:
        sub, rel = key.split("/", 1)
        assert rel in COPIED[sub]


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys, tempfile
from pathlib import Path

BANNED = %r


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import vidsitu_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    vidsitu_tpu_torch.__path__, "vidsitu_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from vidsitu_tpu_torch.parallel import collectives, mesh

assert {"vidsitu_tpu_torch.parallel.collectives",
        "vidsitu_tpu_torch.parallel.mesh"} <= set(names), names
# one process without torchrun's variables: no process group
assert mesh.init_distributed("cpu").type == "cpu"
assert not collectives.is_dist() and collectives.get_world_size() == 1

from vidsitu_tpu_torch.data import get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

with tempfile.TemporaryDirectory() as tmp:
    paths = make_synth_dataset(Path(tmp) / "data", n_train=4, n_valid=2)
    cfg = get_cfg_with_overrides("alone", **{
        **paths, "task_type": "vb_arg",
        "mdl.mdl_name": "sfpret_txe_txd_vbarg", "train.bs": 2,
        "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
        "misc.tmp_path": str(Path(tmp) / "tmp")})
    batch = next(iter(get_data(cfg).valid_dl))
    assert batch["seq_out_by_ev"].shape[:2] == (2, 5), batch.keys()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print("OK", len(names))
"""


def test_port_runs_with_the_jax_package_blocked():
    """Every module of the port imports, and config assembly, the synthetic
    dataset and the data loaders run, in a process where the banned names
    cannot be imported at all."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN % (BANNED,)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    last = proc.stdout.strip().splitlines()[-1].split()
    assert last[0] == "OK" and int(last[1]) > 40, proc.stdout[-500:]


# the JAX modules that each port module re-implements (no copy: they import
# jax or flax), for the language models of the SRL and evrel slice, the
# several-process helpers and the release harness, with the name the
# original imports
REIMPLEMENTED = {
    "verify_release.py": ("verify_release.py", "jax"),
    "models/roberta.py": ("models/roberta.py", "flax"),
    "models/evrel_models.py": ("models/evrel_models.py", "flax"),
    "models/lang_utils.py": ("models/lang_utils.py", "flax"),
    "models/rel_transformer.py": ("models/rel_transformer.py", "flax"),
    "parallel/collectives.py": ("parallel/collectives.py", "jax"),
    "parallel/mesh.py": ("parallel/mesh.py", "jax"),
    "parallel/tensor.py": ("parallel/mesh.py", "jax"),
    # the root entry beside the JAX package
    "dryrun.py": ("../__graft_entry__.py", "jax"),
}


@pytest.mark.parametrize("rel", sorted(REIMPLEMENTED))
def test_language_modules_are_reimplemented_not_imported(rel):
    """Each module has its JAX original beside it, which imports flax (the
    parallel helpers: jax), and imports nothing banned itself; the import
    scan walks it."""
    orig_rel, lib = REIMPLEMENTED[rel]
    port, orig = PORT / rel, JAX_PKG / orig_rel
    assert port.is_file() and orig.is_file()
    assert port in _port_sources()
    assert lib in {root for root, _ in _imported_roots(orig)}
    bad = [root for root, _ in _imported_roots(port) if root in BANNED]
    assert not bad, bad


_BLOCKED_TRAIN = r"""
import sys, tempfile
from pathlib import Path

BANNED = %r


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import torch
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.train.build import build_learner
from vidsitu_tpu_torch.train.learner import batch_to_device
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)
tiny = {"tx_dec.decoder_embed_dim": 32, "tx_dec.encoder_embed_dim": 32,
        "tx_dec.decoder_ffn_embed_dim": 32, "tx_dec.encoder_ffn_embed_dim": 32,
        "tx_dec.decoder_layers": 1, "tx_dec.encoder_layers": 1,
        "rob_mdl.d_model": 32, "rob_mdl.n_layers": 1, "rob_mdl.n_heads": 2,
        "rob_mdl.ffn_dim": 32}
with tempfile.TemporaryDirectory() as tmp:
    paths = make_synth_dataset(Path(tmp) / "data", n_train=2, n_valid=1)
    for task, mdl in (("vb_arg", "sfpret_txe_txd_vbarg"),
                      ("evrel", "sfpret_evrel")):
        cfg = get_cfg_with_overrides("alone", **{
            **paths, **tiny, "task_type": task, "mdl.mdl_name": mdl,
            "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
            "train.dtype": "float32", "misc.tmp_path": str(Path(tmp) / "t")})
        learner = build_learner(cfg, "alone_" + task, "cpu")
        learner.prepare_optimizer(1e-3)
        batch = batch_to_device(next(iter(learner.data.train_dl)),
                                learner.device)
        assert torch.isfinite(learner.train_step(batch))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print("OK")
"""


def test_srl_and_evrel_train_steps_run_with_the_jax_package_blocked():
    """One SRL and one evrel train step with dropout on, through the
    port's build_learner, in a process where the banned names cannot be
    imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_TRAIN % (BANNED,)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"
