"""Shared task metadata ("comm") construction.

The reference builds a Munch dict once in the train dataset and threads it
into every model/loss/eval constructor (dat_loader.py:69-138,
main_dist.py:41-48). Same role here: vocabularies, tokenizers, event/frame
geometry, arg-name tables, and relation label maps.
"""

from __future__ import annotations

from typing import Dict

from ..tokenization import BPETokenizer, Vocabulary
from ..utils.config import CfgNode


def st_ag(ag: str) -> str:
    return f"<{ag}>"


def end_ag(ag: str) -> str:
    return f"</{ag}>"


def enclose_ag_st(agname: str, ag_str: str) -> str:
    return f"{st_ag(agname)} {ag_str}"


def build_comm(cfg: CfgNode) -> CfgNode:
    """Construct the comm node (reference: dat_loader.py:69-138)."""
    ds_cfg = cfg.ds.vsitu
    vid_cfg = cfg.vid_mdl

    comm = CfgNode()
    frm_seq_len = vid_cfg.num_frames * vid_cfg.sampling_rate
    fps = vid_cfg.target_fps
    # event centers: frame 30/90/150/210/270 for 2s events at 30 fps
    comm.cent_frm_per_ev = {
        f"Ev{ix + 1}": int((ix + 1 / 2) * fps * 2) for ix in range(5)
    }
    comm.num_frms = vid_cfg.num_frames
    comm.sampling_rate = vid_cfg.sampling_rate
    comm.frm_seq_len = frm_seq_len
    comm.fps = fps
    comm.max_frms = 300
    comm.num_ev = ds_cfg.num_ev
    assert comm.num_ev == 5
    comm.ev_sep_token = "<EV_SEP>"

    comm["vb_id_vocab"] = Vocabulary.load(ds_cfg.vocab_files.verb_id_vocab)
    comm["gpt2_hf_tok"] = BPETokenizer.from_dir(
        ds_cfg.vocab_files.new_gpt2_vb_arg_vocab
    )
    comm["rob_hf_tok"] = BPETokenizer.from_dir(ds_cfg.vocab_files.roberta_vocab)

    ag_dct = ds_cfg.arg_names
    ag_dct_main: Dict[str, str] = {}
    ag_dct_start: Dict[str, str] = {}
    ag_dct_end: Dict[str, str] = {}
    for agk, agv in ag_dct.items():
        ag_dct_main[agk] = agv
        ag_dct_start[agk] = st_ag(agv)
        ag_dct_end[agk] = end_ag(agv)
    comm["ag_name_dct"] = CfgNode(
        {
            "ag_dct_main": ag_dct_main,
            "ag_dct_start": ag_dct_start,
            "ag_dct_end": ag_dct_end,
        }
    )

    comm["evrel_dct"] = {
        "Null": 0,
        "Causes": 1,
        "Reaction To": 2,
        "Enables": 3,
        "NoRel": 4,
    }
    comm["evrel_dct_opp"] = {v: k for k, v in comm["evrel_dct"].items()}

    comm.path_type = "multi" if vid_cfg.arch == "slowfast" else "single"

    if cfg.task_type == "vb":
        comm.dct_id = "vb_id_vocab"
    elif cfg.task_type == "vb_arg":
        comm.dct_id = "gpt2_hf_tok"
    elif cfg.task_type == "evrel":
        comm.dct_id = "rob_hf_tok"
    else:
        # fail at setup like the reference (dat_loader.py raises
        # NotImplementedError), not later at the first comm.dct_id read
        raise NotImplementedError(f"task_type {cfg.task_type!r}")
    return comm
