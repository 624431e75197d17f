"""Typed hierarchical config system.

TPU-native re-design of the reference's yacs-based config stack
(reference: vidsitu_code/extended_config.py:40-252). Same three-layer
semantics — base YAML defaults -> model-family preset merge -> dotted-key
CLI overrides with existence + type checks — implemented standalone (no
yacs dependency) so the framework is self-contained.

Key behaviors mirrored from the reference:
  * ``update_one_full_key`` asserts the full dotted key already exists and
    the new value's type matches the default's type
    (extended_config.py:84-111).
  * ``pre_proc_config`` merges the video-model preset into ``cfg.vid_mdl``
    and the transformer preset into ``cfg.tx_dec``
    (extended_config.py:146-195).
  * ``cfg_to_flat_dct`` flattens to dotted keys for experiment tracking
    (extended_config.py:205-222).
"""

from __future__ import annotations

import ast
import copy
import json
from pathlib import Path
from typing import Any, Dict, Optional

import re as _re

import yaml


class _CfgYamlLoader(yaml.SafeLoader):
    """SafeLoader that parses scientific notation like ``1e-4`` as float.

    YAML 1.1's float resolver misses exponent-only forms; the reference
    patches this globally (utils/_init_stuff.py:4-17). We scope the fix to
    our own loader instead of mutating the global SafeLoader.
    """


_CfgYamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    _re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
         |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
         |\.[0-9_]+(?:[eE][-+][0-9]+)?
         |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
         |[-+]?\.(?:inf|Inf|INF)
         |\.(?:nan|NaN|NAN))$""",
        _re.X,
    ),
    list("-+0123456789."),
)


def safe_load(stream):
    return yaml.load(stream, Loader=_CfgYamlLoader)


class FrozenConfigError(AttributeError):
    pass


class CfgNode(dict):
    """A dict with attribute access, freezing, and dotted-key helpers."""

    _FROZEN_KEY = "__cfg_frozen__"

    def __init__(self, init: Optional[Dict] = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN_KEY, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value) -> None:
        if self.is_frozen():
            raise FrozenConfigError(
                f"Attempted to set key '{name}' on a frozen CfgNode"
            )
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        super().__setitem__(name, value)

    def _guard_frozen(self, op: str):
        if self.is_frozen():
            raise FrozenConfigError(
                f"Attempted to {op} on a frozen CfgNode"
            )

    # the rest of the dict mutation API must honor freeze() too —
    # guarding only __setitem__/__setattr__ lets cfg.update(...) /
    # del cfg[k] / cfg.pop(k) mutate a supposedly immutable config
    def update(self, *args, **kwargs):
        self._guard_frozen("update")
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __delitem__(self, name):
        self._guard_frozen(f"delete key '{name}'")
        super().__delitem__(name)

    def __delattr__(self, name):
        del self[name]

    def pop(self, *args, **kwargs):
        self._guard_frozen("pop")
        return super().pop(*args, **kwargs)

    def popitem(self):
        self._guard_frozen("popitem")
        return super().popitem()

    def clear(self):
        self._guard_frozen("clear")
        super().clear()

    def setdefault(self, key, default=None):
        if key in self:
            return self[key]
        self._guard_frozen(f"setdefault key '{key}'")
        self[key] = default
        return self[key]

    # -- freezing ----------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN_KEY)

    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN_KEY, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN_KEY, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def clone(self) -> "CfgNode":
        return CfgNode(self.to_dict())

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"CfgNode({super().__repr__()})"

    # -- dotted-key access ---------------------------------------------------
    def get_dotted(self, full_key: str) -> Any:
        d: Any = self
        for part in full_key.split("."):
            assert isinstance(d, CfgNode) and part in d, (
                f"key {full_key} doesnot exist"
            )
            d = d[part]
        return d

    def has_dotted(self, full_key: str) -> bool:
        d: Any = self
        for part in full_key.split("."):
            if not (isinstance(d, CfgNode) and part in d):
                return False
            d = d[part]
        return True

    def set_dotted(self, full_key: str, value: Any, type_check: bool = True):
        """Set an existing dotted key with type verification.

        Mirrors the reference's update_one_full_key
        (extended_config.py:84-111): the key must already exist; string
        values are literal-decoded; the decoded type must match the
        default's type (with int->float promotion, and None-default keys
        accepting anything — matching yacs semantics).
        """
        parts = full_key.split(".")
        d: Any = self
        for part in parts[:-1]:
            assert isinstance(d, CfgNode) and part in d, (
                f"key {full_key} doesnot exist"
            )
            d = d[part]
        leaf = parts[-1]
        assert isinstance(d, CfgNode) and leaf in d, (
            f"key {full_key} doesnot exist"
        )
        old = d[leaf]
        new = _decode_cfg_value(value)
        if type_check:
            new = _check_and_coerce(new, old, full_key)
        d[leaf] = new


def _decode_cfg_value(v: Any) -> Any:
    """Decode a (possibly string) override value like yacs does."""
    if isinstance(v, dict):
        return CfgNode(v)
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce(new: Any, old: Any, full_key: str) -> Any:
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        # bools first: bool is an int subclass.
        if isinstance(new, bool):
            return new
        raise AssertionError(
            f"type mismatch for key {full_key}: expected bool, got {type(new)}"
        )
    if isinstance(new, bool) and isinstance(old, (int, float)):
        # bool subclasses int: a typo'd boolean override would silently
        # become lr=1.0 / bs=True instead of failing like yacs
        raise AssertionError(
            f"type mismatch for key {full_key}: expected {type(old)}, "
            f"got bool"
        )
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    assert isinstance(new, type(old)), (
        f"type mismatch for key {full_key}: expected {type(old)}, got {type(new)}"
    )
    return new


# --------------------------------------------------------------------------
# Config processor
# --------------------------------------------------------------------------

_PKG_CFG_DIR = Path(__file__).resolve().parent.parent / "configs"

VID_MDL_TO_CFG_FPATH = {
    "slow_fast_nl_r50_8x8": "mdl_cfgs/slowfast_8x8_r50.yaml",
    "slow_nl_r50_8x8": "mdl_cfgs/slow_nl_8x8_r50.yaml",
    "c2d_r50_8x8": "mdl_cfgs/c2d_8x8_r50.yaml",
    "i3d_r50_8x8": "mdl_cfgs/i3d_8x8_r50.yaml",
    "i3d_r50_nl_8x8": "mdl_cfgs/i3d_nl_8x8_r50.yaml",
}

TX_TO_CFG_FPATH = {
    "transformer": "tx_cfgs/transformer.yaml",
}


def _load_yaml(path: Path) -> CfgNode:
    with open(path) as f:
        return CfgNode(safe_load(f))


class CfgProcessor:
    """Assembles the full experiment config.

    Layers (reference: extended_config.py:146-195 + main_dist.py:139-158):
      1. base defaults from ``configs/vsitu_cfg.yml``
      2. video-model preset selected by ``mdl.sf_mdl_name`` -> ``cfg.vid_mdl``
      3. transformer preset selected by ``mdl.tx_dec_mdl_name`` -> ``cfg.tx_dec``
      4. dotted-key overrides (existence + type checked)
    """

    def __init__(self, cfg_pth: Optional[str] = None):
        if cfg_pth is None:
            cfg_pth = str(_PKG_CFG_DIR / "vsitu_cfg.yml")
        assert Path(cfg_pth).exists(), f"{cfg_pth} doesn't exist"
        self.cfg_pth = Path(cfg_pth)

    def get_default_cfg(self) -> CfgNode:
        return _load_yaml(self.cfg_pth)

    def pre_proc_config(self, cfg: CfgNode, dct: Optional[Dict] = None) -> CfgNode:
        """Merge model-family presets into the main cfg."""
        vid_name = (
            dct["mdl.sf_mdl_name"]
            if dct and "mdl.sf_mdl_name" in dct
            else cfg.get_dotted("mdl.sf_mdl_name")
        )
        assert vid_name in VID_MDL_TO_CFG_FPATH, f"unknown video model {vid_name}"
        vid_cfg = _load_yaml(_PKG_CFG_DIR / VID_MDL_TO_CFG_FPATH[vid_name])
        cfg["vid_mdl"] = vid_cfg
        # record the merged preset file (reference sets mdl.sf_mdl_cfg_file
        # during its merge, extended_config.py:182)
        cfg["mdl"]["sf_mdl_cfg_file"] = VID_MDL_TO_CFG_FPATH[vid_name]

        tx_name = (
            dct["mdl.tx_dec_mdl_name"]
            if dct and "mdl.tx_dec_mdl_name" in dct
            else cfg.get_dotted("mdl.tx_dec_mdl_name")
        )
        assert tx_name in TX_TO_CFG_FPATH, f"unknown tx model {tx_name}"
        cfg["tx_dec"] = _load_yaml(_PKG_CFG_DIR / TX_TO_CFG_FPATH[tx_name])
        # ditto (extended_config.py:191)
        cfg["mdl"]["tx_dec_cfg_file"] = TX_TO_CFG_FPATH[tx_name]
        return cfg

    def update_from_dict(self, cfg: CfgNode, dct: Dict[str, Any]) -> CfgNode:
        for full_key, v in dct.items():
            cfg.set_dotted(full_key, v)
        return cfg

    @staticmethod
    def cfg_to_flat_dct(cfg: CfgNode) -> Dict[str, Any]:
        def rec(d: Dict, prefix: str, out: Dict):
            for k, v in d.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                if isinstance(v, dict):
                    rec(v, key, out)
                else:
                    out[key] = v
            return out

        return rec(json.loads(json.dumps(cfg.to_dict())), "", {})

    @staticmethod
    def to_str(cfg: CfgNode) -> str:
        return cfg.dump_yaml()


def get_cfg_with_overrides(uid: str = "tmp", **kwargs) -> CfgNode:
    """One-call config assembly used by CLI and tests."""
    cp = CfgProcessor()
    cfg = cp.get_default_cfg()
    cfg = cp.pre_proc_config(cfg, kwargs)
    cfg = cp.update_from_dict(cfg, kwargs)
    cfg["uid"] = uid
    return cfg
