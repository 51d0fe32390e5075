"""Carry the JAX package's objects into the port, as numpy arrays.

The caller converts with ``np.asarray`` (and ``jax.random.key_data`` for a
key, plain ints for params and a recursion layout); these functions build
the port's objects from them, so both packages can be given the same
instance, a folded one included, at small and at big q.  A big-q field of
the JAX package is a two-limb ``Zq2(hi, lo)`` pair; the caller may pass it
as it is (or as any pair with ``hi`` and ``lo``), and it becomes one int64
tensor (hi << 16) | lo.  Signed fields (big-q challenges and digits) stay
signed.  The port never imports a JAX type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .crs import CRS, MaterializedCRS
from .keys import Key
from .params import LabradorParams
from .recursion import FoldedState, RecursionLayout
from .structs import State, Transcript


def tensor(arr, device="cuda") -> torch.Tensor:
    """numpy array, or a two-limb (hi, lo) pair with those attributes ->
    tensor (a copy): integer residues as int64, int8 and bool kept."""
    if hasattr(arr, "hi") and hasattr(arr, "lo"):
        arr = (np.asarray(arr.hi, np.int64) << 16) | np.asarray(arr.lo,
                                                                np.int64)
    a = np.asarray(arr)
    if a.dtype not in (np.int8, np.bool_):
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def key_from_words(words) -> Key:
    """A key from its two uint32 words (``jax.random.key_data(k)``)."""
    w = np.asarray(words, np.uint32).reshape(2)
    return Key(int(w[0]), int(w[1]))


def crs_from_words(words, params: LabradorParams) -> CRS:
    """A CRS from the JAX CRS's (2,) uint32 ``key`` array."""
    w = np.asarray(words, np.uint32).reshape(2)
    return CRS(key=(int(w[0]), int(w[1])), params=params)


def materialized_crs_from_numpy(coeffs, key, params: LabradorParams,
                                device="cuda") -> MaterializedCRS:
    """A MaterializedCRS from a JAX ``MaterializedCRS``'s ``coeffs`` table
    and its (2,) uint32 ``key``."""
    w = np.asarray(key, np.uint32).reshape(2)
    table = torch.tensor(np.asarray(coeffs, np.int32), device=device)
    return MaterializedCRS(coeffs=table, key=(int(w[0]), int(w[1])),
                           params=params)


def state_from_numpy(fields: dict, device="cuda") -> State:
    """A State from {field name: array} of a JAX ``State``."""
    return State(**{f.name: tensor(fields[f.name], device)
                    for f in dataclasses.fields(State)})


def transcript_from_numpy(fields: dict, device="cuda") -> Transcript:
    """A Transcript from {field name: array} of a JAX ``Transcript``."""
    return Transcript(**{f.name: tensor(fields[f.name], device)
                         for f in dataclasses.fields(Transcript)})


def params_from_fields(fields: dict) -> LabradorParams:
    """LabradorParams from the constructor fields of a JAX LabradorParams
    (n, r, q, d, k_count, l_count, q_start and the three overrides; q_start
    carries a big-q configuration)."""
    return LabradorParams(**{f.name: fields[f.name]
                             for f in dataclasses.fields(LabradorParams)
                             if f.init})


def layout_from_fields(fields: dict, params: LabradorParams) -> RecursionLayout:
    """A RecursionLayout from the integer fields of a JAX one, over the
    port's base params."""
    return RecursionLayout(params=params, **{
        f.name: int(fields[f.name]) for f in dataclasses.fields(RecursionLayout)
        if f.name != "params"})


def folded_state_from_numpy(fields: dict, layout: RecursionLayout,
                            base_crs: CRS, device="cuda") -> FoldedState:
    """A FoldedState from {field name: array} of a JAX FoldedState, its
    layout and the base instance's CRS."""
    return FoldedState(base_crs=base_crs, layout=layout, **{
        f.name: tensor(fields[f.name], device)
        for f in dataclasses.fields(FoldedState)
        if f.name not in ("base_crs", "layout")})
