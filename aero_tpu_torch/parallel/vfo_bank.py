"""Batched multi-VFO demodulation, sharded over a device mesh (torch).

Counterpart of ``aero_tpu/parallel/vfo_bank.py``: a bank of B
demodulators of one model is one batched step over a leading VFO axis
(the port's ``msk_step`` / ``oqpsk_step`` are written batched, where JAX
vmaps), and the VFO rows are cut over the mesh's ``vfo`` axis
(``parallel/mesh.py``): each shard's rows step on its device, one shard
after another.  All VFOs advance in lock-step on dense blocks; soft bits
come back [B, bits/block] in row order for the host-side deframers.

Where JAX jits the step with the state donated (``_jit_step``), each
shard's step runs on a card as one CUDA-graph replay whose state lives in
static buffers (``utils/graphs.py``); ``retune`` writes those buffers in
place, so a hunter's retune costs a few small writes and no new capture.

A sharded bank steps smaller batches than an unsharded one, so a
reduction over the batch may run in another order: soft bytes may differ
by one on a few rows at a quantization boundary (the limit that JAX's own
multi-process test allows, +-1 on <= 0.1%).
"""

from __future__ import annotations

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.models import msk as _msk
from aero_tpu_torch.models import oqpsk as _oqpsk
from aero_tpu_torch.parallel.mesh import (Mesh, gather, gather_tree,
                                          make_mesh, shard_over_vfo)
from aero_tpu_torch.utils.graphs import GraphedStep


class VfoBank:
    """B independent demodulators of one model, sharded over a mesh.

    ``mesh=None``: with ``device="cuda"`` (no index) every visible card,
    using the largest count that divides ``n_vfos`` (JAX's rule); with
    ``"cuda:N"`` or ``"cpu"`` that one device."""

    _make_config = staticmethod(_msk.make_config)
    _init = staticmethod(_msk.msk_init)
    _step = staticmethod(_msk.msk_step)

    def __init__(self, n_vfos: int, fs: float, fb: float,
                 mesh: Mesh | None = None, device="cuda", **kw):
        self.cfg = self._make_config(fs, fb, **kw)
        self.n = n_vfos
        if mesh is None:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                n_dev = torch.cuda.device_count()
                while n_vfos % n_dev:
                    n_dev -= 1
                mesh = make_mesh(n_dev)
            else:
                mesh = Mesh([dev])
        self.mesh = mesh
        self.device = mesh.devices[0]
        self._rows = mesh.rows(n_vfos)
        self._steps = []
        self.states = self._init(self.cfg, n_vfos, self.device)

    @property
    def states(self):
        """A copy of the bank's demod state, every row, on its first
        device; assigning it writes the shards' static state buffers."""
        return gather_tree(self.mesh, [s.snapshot() for s in self._steps])

    @states.setter
    def states(self, tree):
        shards = shard_over_vfo(self.mesh, tree)
        if self._steps:
            for s, shard in zip(self._steps, shards):
                s.state = shard
            return
        name = type(self).__name__
        self._steps = [GraphedStep(self._shard_fn(), shard,
                                   f"{name} shard {i} of {len(shards)}")
                       for i, shard in enumerate(shards)]

    def _shard_fn(self):
        def step(state, x):
            return self._step(state, x, self.cfg)
        return step

    @property
    def _shards(self) -> list:
        """Each shard's live state (its graphed step's static buffers)."""
        return [s.state for s in self._steps]

    @property
    def captures(self) -> int:
        """CUDA graphs captured by the bank's steps so far."""
        return sum(s.captures for s in self._steps)

    def process_block(self, samples: np.ndarray):
        """samples: [n_vfos, block_len] real float32 (each shard uploads
        its rows into its step's static input).  Returns the outputs dict,
        tensors on the bank's first device with a leading vfo axis in row
        order."""
        samples = np.ascontiguousarray(samples, np.float32)
        outs = [step(torch.from_numpy(samples[lo:hi]))
                for step, (lo, hi) in zip(self._steps, self._rows)]
        return {k: gather(self.mesh, [o[k] for o in outs]) for k in outs[0]}

    def retune(self, rows, freqs):
        """Force the demodulators in ``rows`` (global row indices) to
        re-acquire at the given audio center frequencies (the reference's
        CenterFreqChangedSlot; ref: decode/decode.cpp:183-226): the fields
        JAX resets, and only those, in the shards that hold the rows,
        written in place into their static state buffers (the captured
        graphs stay valid)."""
        rows = np.asarray(rows, np.int64)
        freqs = np.asarray(freqs, np.float32)
        for step, (lo, hi) in zip(self._steps, self._rows):
            sel = (rows >= lo) & (rows < hi)
            if sel.any():
                _retune_in_place(step.state, rows[sel] - lo, freqs[sel])


def _retune_in_place(st, rows, freqs):
    rows = torch.as_tensor(rows, device=st.freq.device)
    st.freq[rows] = torch.as_tensor(freqs, device=st.freq.device)
    st.mse[rows] = 2.0
    st.have_lock_refs[rows] = False
    st.agc_ema[rows] = 0.0
    st.coarse_y[rows] = 20.0
    # the Doppler slope / clock-rate carries belong to the OLD signal: a
    # stale 100 Hz/s slope would chirp the hunted band and block
    # re-acquisition there
    st.slope[rows] = 0.0
    st.grid_rate[rows] = 0.0


class MskVfoBank(VfoBank):
    """B independent MSK demodulators (600/1200 bps)."""


class OqpskVfoBank(VfoBank):
    """B independent OQPSK demodulators (8400/10500 bps)."""
    _make_config = staticmethod(_oqpsk.make_config)
    _init = staticmethod(_oqpsk.oqpsk_init)
    _step = staticmethod(_oqpsk.oqpsk_step)
