"""Attribute-access view over a (possibly frozen) config mapping.

`as_view` wraps any mapping (a CfgNode, a plain dict) into dotted access;
views hash and compare by content.
"""
from __future__ import annotations

from typing import Any, Mapping


def _freeze(value):
    if isinstance(value, Mapping):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


class CfgView:
    __slots__ = ("_data", "_frozen")

    def __init__(self, data: Mapping):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_frozen", None)

    def __getattr__(self, name: str):
        try:
            value = self._data[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, Mapping):
            return CfgView(value)
        return value

    def __getitem__(self, name):
        return self.__getattr__(name)

    def __contains__(self, name):
        return name in self._data

    def to_dict(self):
        out = {}
        for k, v in self._data.items():
            out[k] = dict(CfgView(v).to_dict()) if isinstance(v, Mapping) \
                else v
        return out

    def _key(self):
        frozen = object.__getattribute__(self, "_frozen")
        if frozen is None:
            frozen = _freeze(self._data)
            object.__setattr__(self, "_frozen", frozen)
        return frozen

    def __eq__(self, other):
        if not isinstance(other, CfgView):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"CfgView({list(self._data.keys())})"


def as_view(cfg) -> CfgView:
    """Wrap a CfgNode / FrozenDict / dict into attribute access; CfgView
    passes through."""
    if isinstance(cfg, CfgView):
        return cfg
    return CfgView(cfg)
