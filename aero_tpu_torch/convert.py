"""Carry JAX state trees into the port and back (jax-free).

The functions work on trees of numpy arrays (a JAX caller makes them with
``jax.tree.map(np.asarray, tree)``).  The JAX fused station keeps its
state complex-free at jit boundaries: a complex leaf is stored as
``{"__c64__": float32 [2, ...]}`` (``aero_tpu/ops/compat.py``), and under
the station's vmap over VFOs that plane axis sits after the VFO axis
(``[nb, 2, ...]``).  This module is the only place in the port that knows
that layout; the port's own states hold complex64 tensors.

Round trips are lossless: float32/int32/bool leaves are copied as they
are, and a complex64 value is exactly its two float32 planes.
"""

from __future__ import annotations

import numpy as np
import torch

from aero_tpu_torch.models.msk import MskState
from aero_tpu_torch.models.oqpsk import OqpskState

_TAG = "__c64__"

# the demod state type of a continuous rate group, by its data rate
DEMOD_STATE = {600: MskState, 1200: MskState,
               8400: OqpskState, 10500: OqpskState}


def _unpack(leaf, axis: int) -> np.ndarray:
    if isinstance(leaf, dict):
        assert set(leaf) == {_TAG}, set(leaf)
        planes = np.asarray(leaf[_TAG], np.float32)
        re = np.take(planes, 0, axis=axis)
        im = np.take(planes, 1, axis=axis)
        out = np.empty(re.shape, np.complex64)
        out.real, out.imag = re, im
        return out
    return np.asarray(leaf)


def _pack(a: np.ndarray, axis: int):
    if np.iscomplexobj(a):
        return {_TAG: np.stack([a.real, a.imag], axis=axis).astype(
            np.float32)}
    return a


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)   # a copy


def state_from_numpy(state, cls, device="cpu", c64_axis: int = 0):
    """A JAX demod state (``MskState`` or ``OqpskState``) of numpy leaves
    -> the port's ``cls`` (the same fields in the same order).

    Leaves may be plain arrays (complex ones included) or packed
    ``{"__c64__": planes}`` with the planes on ``c64_axis`` (1 inside the
    fused station's per-VFO stack).  A state without a batch axis (one
    VFO, float32 scalars) gains a leading [1]."""
    assert tuple(state._fields) == cls._fields, (state._fields, cls)
    leaves = [_unpack(v, c64_axis) for v in state]
    if leaves[0].ndim == 0:
        leaves = [v[None] for v in leaves]
    return cls(*(_to_tensor(v, device) for v in leaves))


def msk_state_from_numpy(state, device="cpu", c64_axis: int = 0) -> MskState:
    """``state_from_numpy`` for a JAX ``MskState``."""
    return state_from_numpy(state, MskState, device, c64_axis)


def state_to_numpy(state, pack: bool = False, c64_axis: int = 0):
    """The port's demod state -> the same NamedTuple of numpy leaves; with
    ``pack`` the complex leaves become ``{"__c64__": planes}``."""
    leaves = [v.detach().cpu().numpy() for v in state]
    if pack:
        leaves = [_pack(v, c64_axis) for v in leaves]
    return type(state)(*leaves)


def fused_state_from_numpy(tree, device="cpu") -> dict:
    """The JAX ``FusedStation._state`` (numpy leaves) -> the port's:
    {"pfb": {out_rate: [2, N] f32}, "grp": {key: {"phase", "demod",
    "hunt"}}} with complex64 PFB carries and a batched demod state, an
    ``MskState`` or ``OqpskState`` by the data rate of the group key
    (out_rate, data_rate, burst).  A burst group has only "phase"."""
    out = {"pfb": {}, "grp": {}}
    for rate, planes in tree["pfb"].items():
        out["pfb"][rate] = _to_tensor(_unpack({_TAG: planes}, 0), device)
    for key, g in tree["grp"].items():
        ng = {"phase": _to_tensor(np.asarray(g["phase"]), device)}
        if "demod" in g:
            ng["demod"] = state_from_numpy(g["demod"], DEMOD_STATE[key[1]],
                                           device, c64_axis=1)
        if "hunt" in g:
            ng["hunt"] = {k: _to_tensor(np.asarray(v), device)
                          for k, v in g["hunt"].items()}
        out["grp"][key] = ng
    return out


def fused_state_to_numpy(state) -> dict:
    """Inverse of ``fused_state_from_numpy``: the JAX station's layout,
    numpy leaves (``jax.tree.map(jnp.asarray, ...)`` makes it a state the
    JAX station can run on)."""
    out = {"pfb": {}, "grp": {}}
    for rate, z in state["pfb"].items():
        out["pfb"][rate] = _pack(z.detach().cpu().numpy(), 0)[_TAG]
    for key, g in state["grp"].items():
        ng = {"phase": g["phase"].detach().cpu().numpy()}
        if "demod" in g:
            ng["demod"] = state_to_numpy(g["demod"], pack=True, c64_axis=1)
        if "hunt" in g:
            ng["hunt"] = {k: v.detach().cpu().numpy()
                          for k, v in g["hunt"].items()}
        out["grp"][key] = ng
    return out
