"""A yacs-compatible configuration node.

Clean-room implementation of the subset of yacs used by the reference
(`third_party/yacs_config.py`): attribute access, typed recursive merge from
YAML file / CLI ``k v`` list, deprecated-key registry (so released ``cfg.yml``
files parse unchanged), ``dump()``/``to_dict()`` and freezing.

PyYAML is imported only inside the functions that parse or emit YAML, so
the config tree builds on a machine without it.
"""
from __future__ import annotations

import copy
import io
from typing import Any

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """Config tree with attribute access and yacs merge semantics."""

    IMMUTABLE = "__immutable__"
    DEPRECATED = "__deprecated_keys__"
    RENAMED = "__renamed_keys__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        init_dict = self._create_tree(init_dict)
        super().__init__(init_dict)
        self.__dict__[CfgNode.IMMUTABLE] = False
        self.__dict__[CfgNode.DEPRECATED] = set()
        self.__dict__[CfgNode.RENAMED] = {}

    @classmethod
    def _create_tree(cls, d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = cls(v)
            else:
                _assert_valid(v, k)
                out[k] = v
        return out

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        _assert_valid(value, name, allow_cfg=True)
        self[name] = value

    # -- mutability -------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self):
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value):
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- deprecated / renamed keys ---------------------------------------
    def register_deprecated_key(self, key):
        self.__dict__[CfgNode.DEPRECATED].add(key)

    def register_renamed_key(self, old, new, message=None):
        self.__dict__[CfgNode.RENAMED][old] = (new, message)

    def key_is_deprecated(self, full_key):
        return full_key in self.__dict__[CfgNode.DEPRECATED]

    def key_is_renamed(self, full_key):
        return full_key in self.__dict__[CfgNode.RENAMED]

    # -- merging ----------------------------------------------------------
    def merge_from_file(self, cfg_filename):
        import yaml
        with open(cfg_filename, "r") as f:
            other = CfgNode(yaml.safe_load(f) or {})
        self.merge_from_other_cfg(other)

    def merge_from_string(self, cfg_str):
        import yaml
        other = CfgNode(yaml.safe_load(cfg_str) or {})
        self.merge_from_other_cfg(other)

    def merge_from_other_cfg(self, other):
        _merge_a_into_b(other, self, self, [])

    def merge_from_list(self, cfg_list):
        assert len(cfg_list) % 2 == 0, (
            f"override list has odd length: {cfg_list}")
        root = self
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if root.key_is_deprecated(full_key):
                continue
            if root.key_is_renamed(full_key):
                root._raise_renamed(full_key)
            parts = full_key.split(".")
            d = self
            for sub in parts[:-1]:
                assert sub in d, f"Non-existent key: {full_key}"
                d = d[sub]
            sub = parts[-1]
            assert sub in d, f"Non-existent key: {full_key}"
            value = _decode_value(v)
            value = _coerce_value_type(value, d[sub], full_key)
            d[sub] = value

    def _raise_renamed(self, full_key):
        new, msg = self.__dict__[CfgNode.RENAMED][full_key]
        raise KeyError(
            f"Key {full_key} was renamed to {new}" + (f"; {msg}" if msg else ""))

    # -- export -----------------------------------------------------------
    def to_dict(self):
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self, **kwargs):
        import yaml
        kwargs.setdefault("default_flow_style", False)
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.dump())

    def clone(self):
        new = CfgNode(self.to_dict())
        new.__dict__[CfgNode.DEPRECATED] = set(self.__dict__[CfgNode.DEPRECATED])
        new.__dict__[CfgNode.RENAMED] = dict(self.__dict__[CfgNode.RENAMED])
        return new

    def __str__(self):
        def _indent(s, n):
            pad = " " * n
            return "\n".join(pad + line if line else line
                             for line in s.split("\n"))

        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.append(_indent(str(v), 2))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self):
        return f"CfgNode({super().__repr__()})"


def _assert_valid(v, key, allow_cfg=True):
    if isinstance(v, CfgNode) and allow_cfg:
        return
    if not isinstance(v, _VALID_TYPES):
        raise ValueError(
            f"Invalid config value type {type(v)} for key {key}")


def _decode_value(v):
    """Decode a CLI string into a python literal (yacs semantics)."""
    if not isinstance(v, str):
        return v
    import yaml
    try:
        loaded = yaml.safe_load(v)
    except yaml.YAMLError:
        return v
    return loaded


def _coerce_value_type(value, existing, full_key):
    """Coerce `value` to the type of `existing`, with yacs's allowed casts."""
    existing_type, value_type = type(existing), type(value)
    if existing is None or value is None or existing_type is value_type:
        return value
    # allowed conversions
    casts = [(tuple, list), (list, tuple), (int, float), (float, int),
             (int, bool), (bool, int), (str, int), (str, float), (str, bool)]
    for src, dst in casts:
        if value_type is src and existing_type is dst:
            try:
                return dst(value)
            except (ValueError, TypeError):
                pass
    raise ValueError(
        f"Type mismatch ({existing_type} vs {value_type}) for key {full_key} "
        f"with value {value}")


def _merge_a_into_b(a, b, root, key_list):
    for k, v_ in a.items():
        full_key = ".".join(key_list + [k])
        if k not in b:
            if root.key_is_deprecated(full_key):
                continue
            if root.key_is_renamed(full_key):
                root._raise_renamed(full_key)
            raise KeyError(f"Non-existent config key: {full_key}")
        v = copy.deepcopy(v_)
        if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], root, key_list + [k])
        else:
            b[k] = _coerce_value_type(v, b[k], full_key)
