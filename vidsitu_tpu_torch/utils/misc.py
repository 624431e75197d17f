"""Small array helpers (reference: utils/misc_utils.py:1-14)."""

from __future__ import annotations


def combine_first_ax(x):
    """(B, E, ...) -> (B*E, ...). Works on numpy and jax arrays."""
    shape = x.shape
    return x.reshape((shape[0] * shape[1],) + tuple(shape[2:]))


def uncombine_first_ax(x, first_dim: int):
    """(B*E, ...) -> (B, E, ...)."""
    shape = x.shape
    assert shape[0] % first_dim == 0
    return x.reshape((first_dim, shape[0] // first_dim) + tuple(shape[1:]))
