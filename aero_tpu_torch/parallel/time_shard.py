"""Time-sharded wideband filtering with halo exchange (torch).

Counterpart of ``aero_tpu/parallel/time_shard.py``: one wideband block is
cut over a ``time`` mesh axis, each shard is filtered on its device, and
the causal filter history crosses each shard boundary as a halo: the left
neighbour's last ``ntaps-1`` samples (the filters) or ``L-M`` samples (the
WOLA filterbank).  Shard 0 takes zeros (the filters) or the stream carry
``state`` (the filterbank).  Inside a process the halo is a copy to the
next shard's device; between processes of a global mesh it is sent to
the next process (``mesh.shift_right``).

A time-sharded input or output is a list of tensors, one per device of
this process, in mesh order (``mesh.shard_over_vfo(mesh, x, "time")`` or
``multihost.scatter_time_shards`` make one; ``mesh.gather`` joins one).
Each shard is computed with the port's own unsharded functions
(``ops/fir.py``, ``channelizer/pfb.py:pfb_channelize``) on its halo and its
samples, so every output sample sees exactly the inputs it sees in the
unsharded pass.  On the CPU the results are bit-identical to that pass
(tests/test_torch_parallel.py); on the card cuDNN and cuFFT may pick
another algorithm for a shorter input, and chip_smoke.py phase 10 states
the largest difference against its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from aero_tpu_torch.channelizer.pfb import pfb_channelize
from aero_tpu_torch.ops.fir import fir_apply, fir_decimate_apply
from aero_tpu_torch.parallel.mesh import Mesh, shift_right


def _halos(mesh: Mesh, shards, n: int, first, axis: str) -> list:
    """For each local shard, the last ``n`` samples of the shard before it
    along ``axis``; the mesh's first shard gets ``first`` (a tensor on its
    device)."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"time sharding needs a mesh with the one axis "
                         f"{axis!r}, not {mesh.axis_names}")
    tails = [x[-n:] for x in shards]
    halos = [None] + [t.to(x.device) for t, x in zip(tails, shards[1:])]
    if mesh.process_count > 1:
        left = shift_right(mesh, tails[-1], shards[0].device)
        halos[0] = first if left is None else left
    else:
        halos[0] = first
    return halos


def _check(mesh: Mesh, shards, need: int, what: str) -> list:
    shards = list(shards)
    if len(shards) != len(mesh.devices):
        raise ValueError(f"{len(shards)} shards for a mesh of "
                         f"{len(mesh.devices)} local devices")
    for x in shards:
        if x.shape[-1] < need:
            raise ValueError(
                f"time shard ({x.shape[-1]}) shorter than the {what} "
                f"({need}): the halo would need to span multiple "
                f"neighbors — use longer blocks or fewer time shards")
    return shards


def halo_filter_time_sharded(mesh: Mesh, taps, axis: str = "time"):
    """A time-sharded causal FIR, shards x [T_i] -> shards y [T_i]: each
    shard filtered after its left neighbour's last ntaps-1 samples (zeros
    before shard 0, a zero initial state)."""
    taps = np.asarray(taps, np.float32)
    k = taps.shape[0]

    def fn(shards):
        shards = _check(mesh, shards, k - 1, "filter history")
        first = torch.zeros_like(shards[0][: k - 1])
        halos = _halos(mesh, shards, k - 1, first, axis)
        return [fir_apply(h, x, taps)[1] for h, x in zip(halos, shards)]
    return fn


def halo_decimate_time_sharded(mesh: Mesh, taps, factor: int,
                               axis: str = "time"):
    """A time-sharded causal FIR keeping every ``factor``-th sample; each
    shard's length must be a multiple of ``factor`` (ValueError), and the
    output shards stay on their devices."""
    taps = np.asarray(taps, np.float32)
    k = taps.shape[0]

    def fn(shards):
        shards = _check(mesh, shards, k - 1, "filter history")
        first = torch.zeros_like(shards[0][: k - 1])
        halos = _halos(mesh, shards, k - 1, first, axis)
        return [fir_decimate_apply(h, x, taps, factor)[1]
                for h, x in zip(halos, shards)]
    return fn


def pfb_channelize_time_sharded(mesh: Mesh, K: int, taps_per_branch: int = 8,
                                axis: str = "time"):
    """A time-sharded WOLA filterbank: ``(state, shards) -> z shards``.

    ``state`` [L-M] complex is the stream carry, consumed by the mesh's
    first shard (for the next block pass the current global block's last
    L-M samples); every other shard takes the L-M = (P-1/2)*K samples
    before it from its left neighbour.  Output shard i is z [K, T_i/M]:
    the hop axis sharded like the input.  A shard shorter than L-M raises
    ValueError, as JAX asserts; so does a shard whose length is not a
    multiple of K, because each shard's output twiddle restarts at its
    first hop and agrees with the unsharded pass only from an even hop."""
    M = K // 2
    hist = taps_per_branch * K - M

    def fn(state, shards):
        shards = _check(mesh, shards, hist, "PFB history")
        for x in shards:
            if x.shape[-1] % K:
                raise ValueError(f"time shard ({x.shape[-1]}) not a "
                                 f"multiple of K={K}")
        first = torch.as_tensor(state).to(shards[0].device)
        halos = _halos(mesh, shards, hist, first, axis)
        return [pfb_channelize(h, x, K, taps_per_branch=taps_per_branch)[1]
                for h, x in zip(halos, shards)]
    return fn
