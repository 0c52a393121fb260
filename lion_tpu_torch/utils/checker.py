"""Shape asserts (copy of lion_tpu/utils/checker.py; reference:
utils/checker.py:10-80).

Always-on sanity checks on static shapes, used where the VAE encodes and
where the local prior reads its input.
"""
from __future__ import annotations


def CHECK2D(t):
    assert len(t.shape) == 2, f"expect 2D, get {t.shape}"


def CHECK3D(t):
    assert len(t.shape) == 3, f"expect 3D, get {t.shape}"


def CHECK4D(t):
    assert len(t.shape) == 4, f"expect 4D, get {t.shape}"


def CHECK5D(t):
    assert len(t.shape) == 5, f"expect 5D, get {t.shape}"


def CHECKDIM(t, dim: int, val: int):
    assert t.shape[dim] == val, \
        f"expect dim {dim} == {val}, get shape {t.shape}"


def CHECKEQ(a, b):
    assert a == b, f"expect {a} == {b}"


def CHECKSIZE(t, shape):
    """shape entries may be ints or lists of allowed values."""
    assert len(t.shape) == len(shape), f"rank mismatch {t.shape} vs {shape}"
    for i, s in enumerate(shape):
        allowed = s if isinstance(s, (list, tuple)) else [s]
        assert t.shape[i] in allowed, \
            f"dim {i}: {t.shape[i]} not in {allowed} (shape {t.shape})"
