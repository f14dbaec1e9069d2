"""Batched multi-VFO demodulation, sharded over a device mesh (torch).

Counterpart of ``aero_tpu/parallel/vfo_bank.py``: a bank of B
demodulators of one model is one batched step over a leading VFO axis
(the port's ``msk_step`` / ``oqpsk_step`` are written batched, where JAX
vmaps), and the VFO rows are cut over the mesh's ``vfo`` axis
(``parallel/mesh.py``): each shard's rows step on its device, one shard
after another.  All VFOs advance in lock-step on dense blocks; soft bits
come back [B, bits/block] in row order for the host-side deframers.

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
        self.states = self._init(self.cfg, n_vfos, self.device)

    @property
    def states(self):
        """The bank's demod state, every row, on its first device."""
        return gather_tree(self.mesh, self._shards)

    @states.setter
    def states(self, tree):
        self._shards = shard_over_vfo(self.mesh, tree)

    def process_block(self, samples: np.ndarray):
        """samples: [n_vfos, block_len] real float32 (each shard uploads
        its rows).  Returns the outputs dict, tensors on the bank's first
        device with a leading vfo axis in row order."""
        samples = np.ascontiguousarray(samples, np.float32)
        outs = []
        for i, (dev, (lo, hi)) in enumerate(zip(self.mesh.devices,
                                                self._rows)):
            x = torch.from_numpy(samples[lo:hi]).to(dev)
            self._shards[i], out = self._step(self._shards[i], x, self.cfg)
            outs.append(out)
        return {k: gather(self.mesh, [o[k] for o in outs]) for k in outs[0]}

    def retune(self, rows, freqs):
        """Force the demodulators in ``rows`` (global row indices) to
        re-acquire at the given audio center frequencies (the reference's
        CenterFreqChangedSlot; ref: decode/decode.cpp:183-226): the fields
        JAX resets, and only those, in the shards that hold the rows."""
        rows = np.asarray(rows, np.int64)
        freqs = np.asarray(freqs, np.float32)
        for i, (dev, (lo, hi)) in enumerate(zip(self.mesh.devices,
                                                self._rows)):
            sel = (rows >= lo) & (rows < hi)
            if sel.any():
                self._shards[i] = _retuned(self._shards[i], rows[sel] - lo,
                                           freqs[sel], dev)


def _retuned(st, rows, freqs, device):
    rows = torch.as_tensor(rows, device=device)
    freqs = torch.as_tensor(freqs, device=device)

    def put(field, value):
        out = field.clone()
        out[rows] = value
        return out
    return st._replace(
        freq=put(st.freq, freqs),
        mse=put(st.mse, 2.0),
        have_lock_refs=put(st.have_lock_refs, False),
        agc_ema=put(st.agc_ema, 0.0),
        coarse_y=put(st.coarse_y, 20.0),
        # the Doppler slope / clock-rate carries belong to the OLD
        # signal: a stale 100 Hz/s slope would chirp the hunted band
        # and block re-acquisition there
        slope=put(st.slope, 0.0),
        grid_rate=put(st.grid_rate, 0.0))


class MskVfoBank(VfoBank):
    """B independent MSK demodulators (600/1200 bps)."""


class OqpskVfoBank(VfoBank):
    """B independent OQPSK demodulators (8400/10500 bps)."""
    _make_config = staticmethod(_oqpsk.make_config)
    _init = staticmethod(_oqpsk.oqpsk_init)
    _step = staticmethod(_oqpsk.oqpsk_step)
