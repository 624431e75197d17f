"""Plain-Python symbol vocabulary (fairseq ``Dictionary`` equivalent).

The reference's verb vocab is a pickled fairseq Dictionary exposing
``.indices`` / ``.symbols`` / ``.unk_index`` / ``.pad_index``
(dat_loader.py:204-213, evl_vsitu.py:57). This class provides the same
attribute surface with JSON persistence (no fairseq, no pickle-of-class).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


class Vocabulary:
    def __init__(
        self,
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
        bos: str = "<s>",
    ):
        self.symbols: List[str] = []
        self.indices: Dict[str, int] = {}
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = (
            bos,
            pad,
            eos,
            unk,
        )
        # fairseq order: bos=0, pad=1, eos=2, unk=3
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)

    def add_symbol(self, sym: str) -> int:
        if sym in self.indices:
            return self.indices[sym]
        idx = len(self.symbols)
        self.symbols.append(sym)
        self.indices[sym] = idx
        return idx

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def __getitem__(self, idx: int) -> str:
        return self.symbols[idx] if 0 <= idx < len(self.symbols) else self.unk_word

    def __len__(self) -> int:
        return len(self.symbols)

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    # fairseq protocol
    def pad(self) -> int:
        return self.pad_index

    def unk(self) -> int:
        return self.unk_index

    def eos(self) -> int:
        return self.eos_index

    def bos(self) -> int:
        return self.bos_index

    # -- persistence -----------------------------------------------------------
    def save_json(self, fpath) -> None:
        Path(fpath).parent.mkdir(parents=True, exist_ok=True)
        with open(fpath, "w") as f:
            json.dump({"symbols": self.symbols}, f, indent=0)

    @classmethod
    def load_json(cls, fpath) -> "Vocabulary":
        with open(fpath) as f:
            data = json.load(f)
        syms = data["symbols"]
        v = cls(bos=syms[0], pad=syms[1], eos=syms[2], unk=syms[3])
        for s in syms[4:]:
            v.add_symbol(s)
        return v

    @classmethod
    def from_symbols(cls, extra_symbols: List[str]) -> "Vocabulary":
        v = cls()
        for s in extra_symbols:
            v.add_symbol(s)
        return v

    @classmethod
    def load(cls, fpath) -> "Vocabulary":
        """Load from json; also accepts a pickled fairseq Dictionary
        (duck-typed) for drop-in use of reference vocab files. The
        unpickler substitutes a stub for any unimportable class, so the
        reference pickles load without fairseq installed."""
        fpath = Path(fpath)
        if fpath.suffix == ".json":
            return cls.load_json(fpath)
        import pickle

        class _Stub:
            def __init__(self, *a, **k):
                pass

        class _TolerantUnpickler(pickle.Unpickler):
            def find_class(self, module, name):
                try:
                    return super().find_class(module, name)
                except (ImportError, AttributeError):
                    return type(name, (_Stub,), {})

        with open(fpath, "rb") as f:
            obj = _TolerantUnpickler(f).load()
        if isinstance(obj, cls):
            return obj
        v = cls.__new__(cls)
        v.symbols = list(obj.symbols)
        v.indices = dict(obj.indices)
        v.pad_index = obj.pad_index
        v.unk_index = obj.unk_index
        v.eos_index = obj.eos_index
        v.bos_index = getattr(obj, "bos_index", 0)
        v.bos_word, v.pad_word = v.symbols[v.bos_index], v.symbols[v.pad_index]
        v.eos_word, v.unk_word = v.symbols[v.eos_index], v.symbols[v.unk_index]
        return v
