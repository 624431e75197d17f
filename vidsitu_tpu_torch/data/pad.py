"""Token padding / shifting utilities (numpy).

Ports of the reference helpers (utils/dat_utils.py:172-291) with identical
truncation/eos edge semantics, emitting numpy instead of torch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pad_tokens(
    lst,
    pad_index: int,
    pad_side: str,
    append_eos: bool,
    eos_index: int,
    max_len: int,
) -> Tuple[np.ndarray, List[int]]:
    """Pad/truncate a token list; returns (ids[max_len], attn_mask list).

    Matches reference pad_tokens (dat_utils.py:190-230) including the
    append_eos-on-truncation behavior (last position overwritten by eos).
    """
    lst = list(lst)
    curr_len = len(lst)
    out = np.full((max_len,), pad_index, dtype=np.int64)
    if append_eos:
        if curr_len >= max_len:
            out[:max_len] = lst[:max_len]
            out[max_len - 1] = eos_index
            out_len = max_len
        else:
            if pad_side == "right":
                out[:curr_len] = lst
                out[curr_len] = eos_index
            else:
                # left padding: [pad..., seq, eos] — writing the eos at
                # index curr_len would land it inside the padding region
                out[max_len - curr_len - 1 : max_len - 1] = lst
                out[max_len - 1] = eos_index
            out_len = curr_len + 1
    else:
        if curr_len >= max_len:
            out[:max_len] = lst[:max_len]
            out_len = max_len
        else:
            if pad_side == "right":
                out[:curr_len] = lst
            else:
                out[max_len - curr_len :] = lst
            out_len = curr_len
    if pad_side == "right":
        attn_mask = [1] * out_len + [0] * (max_len - out_len)
    else:
        attn_mask = [0] * (max_len - out_len) + [1] * out_len
    assert len(attn_mask) == max_len
    return out, attn_mask


def pad_words_new(
    sent: str,
    max_len: int,
    wvoc,
    append_eos: bool = False,
    pad_side: str = "right",
    prefix_lst: List[int] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Tokenize then pad (reference: dat_utils.py:233-261, HF branch)."""
    assert pad_side in ("left", "right")
    sent_enc = wvoc(sent)["input_ids"]
    if prefix_lst is not None:
        sent_enc = list(prefix_lst) + list(sent_enc)
    return pad_tokens(
        sent_enc,
        pad_index=wvoc.pad_token_id,
        pad_side=pad_side,
        append_eos=append_eos,
        eos_index=wvoc.eos_token_id,
        max_len=max_len,
    )


def add_prev_tokens(src: np.ndarray, pad_token: int, bos_token: int) -> np.ndarray:
    """BOS-shift along the last axis (reference: dat_utils.py:282-291)."""
    prev = np.full_like(src, pad_token)
    prev[..., 0] = bos_token
    prev[..., 1:] = src[..., :-1]
    return prev


def truncate_batch(inp_dict, key: str, max_len: int, dim: int) -> None:
    """In-place truncation along dim (reference: dat_utils.py:152-169)."""
    sl = [slice(None)] * inp_dict[key].ndim
    sl[dim] = slice(0, max_len)
    inp_dict[key] = inp_dict[key][tuple(sl)]


def coalesce_dicts(dct_list):
    """Merge dicts, asserting equal values on key collisions
    (reference: dat_utils.py:112-124)."""
    import numpy as _np

    out = {}
    for dct in dct_list:
        for k in dct:
            if k in out:
                assert _np.all(out[k] == dct[k])
        out.update(dct)
    return out
