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


def fused_state_from_numpy(tree, device="cpu") -> dict:
    """The JAX ``FusedStation._state`` (numpy leaves) -> the port's:
    {"pfb": {out_rate: [2, N] f32}, "grp": {key: {"phase", "demod",
    "hunt"}}} with complex64 PFB carries and a batched demod state, an
    ``MskState`` or ``OqpskState`` by the data rate of the group key
    (out_rate, data_rate, burst).  A burst group has only "phase", and
    on the 4x filterbank plan an OQPSK one "chan" too (its low-pass's
    carry, float32 [n, taps - 1])."""
    out = {"pfb": {}, "grp": {}}
    for rate, planes in tree["pfb"].items():
        out["pfb"][rate] = planes_to_c64(planes, device)
    for key, g in tree["grp"].items():
        ng = {"phase": _to_tensor(np.asarray(g["phase"]), device)}
        if "demod" in g:
            ng["demod"] = state_from_numpy(g["demod"], DEMOD_STATE[key[1]],
                                           device, c64_axis=1)
        if "hunt" in g:
            ng["hunt"] = {k: _to_tensor(np.asarray(v), device)
                          for k, v in g["hunt"].items()}
        if "chan" in g:
            ng["chan"] = _to_tensor(np.asarray(g["chan"]), device)
        out["grp"][key] = ng
    return out


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree_util.tree_leaves`` order: dict
    keys sorted, NamedTuple fields and list/tuple items in order, a packed
    ``{"__c64__": planes}`` one leaf (its planes).  A checkpoint's
    ``dev_i`` entries are these leaves, so the order must be JAX's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """Inverse of ``tree_leaves``: a tree shaped like ``template`` (dict
    keys in the template's order, NamedTuple types kept) whose leaves are
    taken from ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_to_numpy(tree, c64_axis: int = 1):
    """A port tree of tensors (dicts, lists, NamedTuples) -> the JAX
    layout: numpy leaves, complex ones packed as ``{"__c64__": planes}``
    with the planes on ``c64_axis`` (1 under a per-VFO stack)."""
    if isinstance(tree, torch.Tensor):
        return _pack(tree.detach().cpu().numpy(), c64_axis)
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v, c64_axis) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v, c64_axis) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v, c64_axis) for v in tree)
    return tree


def tree_from_numpy(tree, device="cpu", c64_axis: int = 1):
    """Inverse of ``tree_to_numpy``: tensors on ``device``, packed complex
    leaves back to complex64."""
    if isinstance(tree, dict):
        if set(tree) == {_TAG}:
            return _to_tensor(_unpack(tree, c64_axis), device)
        return {k: tree_from_numpy(v, device, c64_axis)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_from_numpy(v, device, c64_axis)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device, c64_axis) for v in tree)
    return _to_tensor(np.asarray(tree), device)


def planes_to_c64(planes, device="cpu") -> torch.Tensor:
    """float32 [2, ...] re/im planes (an unbatched packed carry, such as
    a filterbank's) -> a complex64 tensor on ``device``."""
    return _to_tensor(_unpack({_TAG: planes}, 0), device)


def c64_to_planes(z: torch.Tensor) -> np.ndarray:
    """Inverse of ``planes_to_c64``."""
    return _pack(z.detach().cpu().numpy(), 0)[_TAG]


def fused_state_to_numpy(state) -> dict:
    """Inverse of ``fused_state_from_numpy``: the JAX station's layout,
    numpy leaves (``jax.tree.map(jnp.asarray, ...)`` makes it a state the
    JAX station can run on)."""
    return {"pfb": {rate: c64_to_planes(z)
                    for rate, z in state["pfb"].items()},
            "grp": tree_to_numpy(state["grp"])}
