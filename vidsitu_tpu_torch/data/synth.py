"""Synthetic VidSitu-format dataset fabrication.

Generates annotation/split/vinfo JSONs, vocab directories, pre-extracted
feature files, and (optionally) frame JPEGs in exactly the layout the real
VidSitu release uses (reference: data/DATA_PREP.md, dat_loader.py:140-173).
Used by the test-suite as the stand-in for the real dataset (which cannot
be downloaded in a hermetic environment) and by demo/bench tooling.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..tokenization import (
    Vocabulary,
    build_vidsitu_gpt2_tokenizer,
    make_roberta_tokenizer,
    train_byte_level_bpe,
)

VERB_POOL = [
    "speak.01", "walk.01", "open.01", "stare.01", "gesture.01", "drive.01",
    "look.01", "hold.01", "run.02", "sit.01", "stand.01", "turn.01",
    "throw.01", "grab.01", "smile.01", "fall.01", "jump.01", "push.01",
]

NOUN_POOL = [
    "man", "woman", "dog", "car", "bed", "door", "ball", "child", "group",
    "soldier", "officer", "girl", "boy", "crowd",
]

MOD_POOL = ["in a white shirt", "with a hat", "in the park", "near the door", ""]

SCENE_POOL = ["in a home", "in a street", "in a park", "in an office"]

ARG_ROLES = [
    ("Arg0", 0.9),
    ("Arg1", 0.8),
    ("Arg2", 0.3),
    ("Scene of the Event", 0.85),
    ("ArgM (direction)", 0.2),
    ("ArgM (location)", 0.3),
    ("ArgM (manner)", 0.25),
    ("ArgM (purpose)", 0.15),
    ("ArgM (goal)", 0.1),
]

EVREL_POOL = ["Causes", "Reaction To", "Enables", "NoRel"]

ARG_NAMES_CANON = [
    "Vb", "Arg0", "Arg1", "Arg2", "Arg3", "Arg4", "AScn", "ALoc", "APrp",
    "AGol", "ADir", "AMnr",
]


def _phrase(rng: np.random.Generator) -> str:
    n = NOUN_POOL[rng.integers(len(NOUN_POOL))]
    m = MOD_POOL[rng.integers(len(MOD_POOL))]
    det = ["a", "the"][rng.integers(2)]
    return f"{det} {n} {m}".strip()


def _event_skeleton(rng: np.random.Generator) -> Dict:
    """Pick the verb + role set for one event.

    All annotators of a video share this skeleton: the reference's SRL
    scorer indexes every GT annotator with the same arg keys
    (evl_fns.py:497), an invariant of the real dataset that synthetic
    data must respect.
    """
    vb = VERB_POOL[rng.integers(len(VERB_POOL))]
    roles = [role for role, p in ARG_ROLES if rng.random() < p]
    if not roles:
        roles = ["Arg0"]
    return {"vb": vb, "roles": roles}


def _one_event_ann(
    rng: np.random.Generator, vid_seg: str, ev: int, skel: Dict
) -> Dict:
    args = {}
    arg_list = {}
    for order, role in enumerate(skel["roles"]):
        if role == "Scene of the Event":
            txt = SCENE_POOL[rng.integers(len(SCENE_POOL))]
        else:
            txt = _phrase(rng)
        args[role] = txt
        arg_list[role] = str(order)
    ann = {
        "vid_seg_int": vid_seg,
        "VerbID": skel["vb"],
        "Args": args,
        "Arg_List": arg_list,
    }
    if ev != 3:
        ann["EvRel"] = EVREL_POOL[rng.integers(len(EVREL_POOL))]
    return ann


def _one_video_ann(
    rng: np.random.Generator, vid_seg: str, skels: Dict
) -> Dict:
    return {
        f"Ev{ev}": _one_event_ann(rng, vid_seg, ev, skels[f"Ev{ev}"])
        for ev in range(1, 6)
    }


def make_synth_dataset(
    root,
    n_train: int = 8,
    n_valid: int = 6,
    n_test: int = 4,
    feat_dim: int = 2048,
    vocab_size: int = 384,
    seed: int = 0,
    with_frames: bool = False,
    frame_hw: int = 32,
) -> Dict:
    """Fabricate a full dataset tree under ``root``.

    Returns a dict of config-override paths suitable for
    ``CfgNode.set_dotted``.
    """
    root = Path(root)
    rng = np.random.default_rng(seed)

    ann_dir = root / "vidsitu_annotations"
    split_dir = ann_dir / "split_files"
    vseg_dir = ann_dir / "vseg_ann_files"
    vinfo_dir = ann_dir / "vinfo_files"
    vocab_dir = root / "vsitu_vocab"
    feats_dir = root / "vsitu_vid_feats" / "i3d_synth"
    frames_dir = root / "vsitu_frames"
    for d in (split_dir, vseg_dir, vinfo_dir, vocab_dir, feats_dir):
        d.mkdir(parents=True, exist_ok=True)

    def seg_names(prefix: str, n: int) -> List[str]:
        return [f"v_{prefix}_seg_{i:03d}" for i in range(n)]

    splits = {
        "train": seg_names("trn", n_train),
        "valid": seg_names("val", n_valid),
        "test_verb": seg_names("tvb", n_test),
        "test_srl": seg_names("tsrl", n_test),
        "test_evrel": seg_names("tevr", n_test),
    }
    split_fname = {
        "train": "vseg_split_train_lb.json",
        "valid": "vseg_split_valid_lb.json",
        "test_verb": "vseg_split_testvb_lb.json",
        "test_srl": "vseg_split_testsrl_lb.json",
        "test_evrel": "vseg_split_testevrel_lb.json",
    }
    ann_fname = {
        "train": "vsann_train_lb.json",
        "valid": "vsann_valid_lb.json",
        "test_verb": "vsann_testvb_lb.json",
        "test_srl": "vsann_testsrl_lb.json",
        "test_evrel": "vsann_testevrel_lb.json",
    }
    vinfo_fname = {
        "train": "vinfo_train_lb.json",
        "valid": "vinfo_valid_lb.json",
        "test_verb": "vinfo_testvb_lb.json",
        "test_srl": "vinfo_testsrl_lb.json",
        "test_evrel": "vinfo_testevrel_lb.json",
    }

    corpus: List[str] = []
    for split, segs in splits.items():
        with open(split_dir / split_fname[split], "w") as f:
            json.dump(segs, f)

        n_ann_per_seg = 1 if split == "train" else 3
        ann_lst = []
        vinfo_lst = []
        for seg in segs:
            skels = {f"Ev{ev}": _event_skeleton(rng) for ev in range(1, 6)}
            for _ in range(n_ann_per_seg):
                ann = _one_video_ann(rng, seg, skels)
                ann_lst.append(ann)
                for ev in range(1, 6):
                    corpus.append(ann[f"Ev{ev}"]["VerbID"])
                    corpus.extend(ann[f"Ev{ev}"]["Args"].values())
            # vinfo: 10 verb annotations per event (>=9 asserted by readers)
            vinfo_lst.append(
                {
                    "vid_seg_int": seg,
                    "vbid_lst": {
                        f"Ev{ev}": [
                            VERB_POOL[rng.integers(len(VERB_POOL))]
                            for _ in range(10)
                        ]
                        for ev in range(1, 6)
                    },
                }
            )
        with open(vseg_dir / ann_fname[split], "w") as f:
            json.dump(ann_lst, f)
        with open(vinfo_dir / vinfo_fname[split], "w") as f:
            json.dump(vinfo_lst, f)

        # pre-extracted features for every segment
        for seg in segs:
            feats = rng.standard_normal((5, feat_dim)).astype(np.float32)
            np.save(feats_dir / f"{seg}_feats.npy", feats)

        if with_frames:
            from PIL import Image

            for seg in segs:
                seg_dir = frames_dir / seg
                seg_dir.mkdir(parents=True, exist_ok=True)
                for ix in range(1, 301):
                    arr = rng.integers(
                        0, 255, size=(frame_hw, frame_hw, 3), dtype=np.uint8
                    )
                    Image.fromarray(arr.astype(np.uint8)).save(
                        seg_dir / f"{seg}_{ix:06d}.jpg"
                    )

    # ---- vocabularies -------------------------------------------------------
    verb_voc = Vocabulary.from_symbols(VERB_POOL)
    verb_voc.save_json(vocab_dir / "verb_id_vocab.json")

    bpe = train_byte_level_bpe(corpus, vocab_size=vocab_size)
    gpt2_tok = build_vidsitu_gpt2_tokenizer(
        bpe, verb_ids=VERB_POOL, arg_names=[a for a in ARG_NAMES_CANON if a != "Vb"]
    )
    gpt2_tok.save_dir(vocab_dir / "bpe_with_seps_vb_arg_vocab")
    rob_tok = make_roberta_tokenizer(bpe)
    rob_tok.save_dir(vocab_dir / "roberta_base_vocab")

    return {
        "ds.vsitu.split_files_lb.train": str(split_dir / split_fname["train"]),
        "ds.vsitu.split_files_lb.valid": str(split_dir / split_fname["valid"]),
        "ds.vsitu.split_files_lb.test_verb": str(split_dir / split_fname["test_verb"]),
        "ds.vsitu.split_files_lb.test_srl": str(split_dir / split_fname["test_srl"]),
        "ds.vsitu.split_files_lb.test_evrel": str(
            split_dir / split_fname["test_evrel"]
        ),
        "ds.vsitu.vsitu_ann_files_lb.train": str(vseg_dir / ann_fname["train"]),
        "ds.vsitu.vsitu_ann_files_lb.valid": str(vseg_dir / ann_fname["valid"]),
        "ds.vsitu.vsitu_ann_files_lb.test_verb": str(vseg_dir / ann_fname["test_verb"]),
        "ds.vsitu.vsitu_ann_files_lb.test_srl": str(vseg_dir / ann_fname["test_srl"]),
        "ds.vsitu.vsitu_ann_files_lb.test_evrel": str(
            vseg_dir / ann_fname["test_evrel"]
        ),
        "ds.vsitu.vinfo_files_lb.train": str(vinfo_dir / vinfo_fname["train"]),
        "ds.vsitu.vinfo_files_lb.valid": str(vinfo_dir / vinfo_fname["valid"]),
        "ds.vsitu.vinfo_files_lb.test_verb": str(vinfo_dir / vinfo_fname["test_verb"]),
        "ds.vsitu.vinfo_files_lb.test_srl": str(vinfo_dir / vinfo_fname["test_srl"]),
        "ds.vsitu.vinfo_files_lb.test_evrel": str(
            vinfo_dir / vinfo_fname["test_evrel"]
        ),
        "ds.vsitu.vocab_files.verb_id_vocab": str(vocab_dir / "verb_id_vocab.json"),
        "ds.vsitu.vocab_files.new_gpt2_vb_arg_vocab": str(
            vocab_dir / "bpe_with_seps_vb_arg_vocab"
        ),
        "ds.vsitu.vocab_files.roberta_vocab": str(vocab_dir / "roberta_base_vocab"),
        "ds.vsitu.vsit_frm_feats_dir": str(feats_dir),
        "ds.vsitu.video_frms_tdir": str(frames_dir),
    }


# ---------------------------------------------------------------------------
# Real-format release fabrication (verify_release's test substrate)
# ---------------------------------------------------------------------------
def _pickle_as_fairseq_dictionary(voc: Vocabulary, out_path: Path) -> None:
    """Pickle ``voc``'s state under the class path
    ``fairseq.data.dictionary.Dictionary`` WITHOUT fairseq installed,
    by registering throwaway module objects for the dump. Loading the
    result without fairseq exercises Vocabulary.load's tolerant
    unpickler — exactly what a real release pickle does
    (dat_loader.py:81-83)."""
    import pickle
    import sys
    import types

    class Dictionary:  # noqa: D401 - shape-only stand-in
        pass

    Dictionary.__module__ = "fairseq.data.dictionary"
    Dictionary.__qualname__ = "Dictionary"

    mods = {}
    for name in ("fairseq", "fairseq.data", "fairseq.data.dictionary"):
        mods[name] = sys.modules.get(name)
        sys.modules[name] = types.ModuleType(name)
    sys.modules["fairseq.data.dictionary"].Dictionary = Dictionary
    try:
        d = Dictionary()
        d.symbols = list(voc.symbols)
        d.indices = dict(voc.indices)
        d.count = [1] * len(voc.symbols)
        d.pad_index = voc.pad_index
        d.unk_index = voc.unk_index
        d.eos_index = voc.eos_index
        d.bos_index = voc.bos_index
        d.pad_word, d.unk_word = voc.pad_word, voc.unk_word
        d.eos_word, d.bos_word = voc.eos_word, voc.bos_word
        with open(out_path, "wb") as f:
            pickle.dump(d, f)
    finally:
        for name, old in mods.items():
            if old is None:
                del sys.modules[name]
            else:
                sys.modules[name] = old


def make_release_tree(
    root,
    n_train: int = 6,
    n_valid: int = 4,
    n_test: int = 3,
    feat_dim: int = 2048,
    vocab_size: int = 384,
    seed: int = 0,
    with_frames: bool = False,
    frame_hw: int = 32,
) -> Path:
    """Fabricate a REAL-FORMAT VidSitu release under ``root``: the
    reference's ``./data`` layout with PICKLED vocab artifacts — a live
    ``transformers.GPT2TokenizerFast`` (dat_loader.py:87-89) and a
    fairseq-``Dictionary``-shaped pickle (dat_loader.py:81-83) — i.e.
    the inputs ``python -m vidsitu_tpu.verify_release`` validates.

    Builds on :func:`make_synth_dataset` (same annotations/feats/frames)
    and replaces the vocab artifacts with their release formats.
    """
    import pickle
    import tempfile

    root = Path(root)
    make_synth_dataset(
        root,
        n_train=n_train,
        n_valid=n_valid,
        n_test=n_test,
        feat_dim=feat_dim,
        vocab_size=vocab_size,
        seed=seed,
        with_frames=with_frames,
        frame_hw=frame_hw,
    )
    vocab_dir = root / "vsitu_vocab"

    # 1. verb vocab: pickled fairseq-Dictionary shape
    verb_voc = Vocabulary.from_symbols(VERB_POOL)
    _pickle_as_fairseq_dictionary(verb_voc, vocab_dir / "verb_id_vocab.pkl")

    # 2. GPT-2 task vocab: a pickled LIVE HF fast tokenizer with the
    #    reference's added-token construction (dat_loader.py:99-122)
    from transformers import GPT2TokenizerFast

    # rebuild the same base BPE the synth vocab dirs use
    corpus: List[str] = []
    for split_fname in (root / "vidsitu_annotations" / "vseg_ann_files").iterdir():
        for ann in json.loads(split_fname.read_text()):
            for ev in range(1, 6):
                corpus.append(ann[f"Ev{ev}"]["VerbID"])
                corpus.extend(ann[f"Ev{ev}"]["Args"].values())
    bpe = train_byte_level_bpe(corpus, vocab_size=vocab_size)
    with tempfile.TemporaryDirectory() as td:
        base = dict(bpe.encoder)
        # real GPT-2 carries <|endoftext|> in the BASE vocab (id 50256)
        if "<|endoftext|>" not in base:
            base["<|endoftext|>"] = len(base)
        with open(Path(td) / "vocab.json", "w", encoding="utf-8") as f:
            json.dump(base, f, ensure_ascii=False)
        with open(Path(td) / "merges.txt", "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in sorted(
                bpe.bpe_ranks.items(), key=lambda kv: kv[1]
            ):
                f.write(f"{a} {b}\n")
        hf_tok = GPT2TokenizerFast(
            vocab_file=str(Path(td) / "vocab.json"),
            merges_file=str(Path(td) / "merges.txt"),
            unk_token="<|endoftext|>",
            bos_token="<|endoftext|>",
            eos_token="<|endoftext|>",
        )
    seps = ["<EV_SEP>"]
    for ag in ARG_NAMES_CANON:
        if ag == "Vb":
            continue
        seps.extend([f"<{ag}>", f"</{ag}>"])
    hf_tok.add_tokens(seps)
    hf_tok.add_tokens(list(VERB_POOL))
    hf_tok.add_special_tokens({"pad_token": "<|pad|>"})
    with open(vocab_dir / "bpe_with_seps_vb_arg_vocab.pkl", "wb") as f:
        pickle.dump(hf_tok, f)
    return root
