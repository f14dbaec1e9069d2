"""Batched multi-VFO demodulation on one device (torch).

Counterpart of ``aero_tpu/parallel/vfo_bank.py``: a bank of B
demodulators of one model is one batched step over a leading VFO axis
(the port's ``msk_step`` / ``oqpsk_step`` are written batched, where JAX
vmaps).  All VFOs advance in lock-step on dense blocks; soft bits come
back [B, bits/block] for the host-side deframers.  The JAX bank shards
the VFO axis over a device mesh; this one runs on one ``device`` (the
mesh, ``mesh=``, is ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.models import msk as _msk
from aero_tpu_torch.models import oqpsk as _oqpsk


class VfoBank:
    """B independent demodulators of one model as one batched step."""

    _make_config = staticmethod(_msk.make_config)
    _init = staticmethod(_msk.msk_init)
    _step = staticmethod(_msk.msk_step)

    def __init__(self, n_vfos: int, fs: float, fb: float, device="cuda",
                 **kw):
        self.cfg = self._make_config(fs, fb, **kw)
        self.n = n_vfos
        self.device = resolve_device(device)
        self.states = self._init(self.cfg, n_vfos, self.device)

    def process_block(self, samples: np.ndarray):
        """samples: [n_vfos, block_len] real float32.  Returns the outputs
        dict (tensors on the bank's device) with a leading vfo axis."""
        x = torch.from_numpy(np.ascontiguousarray(samples, np.float32)).to(
            self.device)
        self.states, out = self._step(self.states, x, self.cfg)
        return out

    def retune(self, rows, freqs):
        """Force the demodulators in ``rows`` to re-acquire at the given
        audio center frequencies (the reference's CenterFreqChangedSlot;
        ref: decode/decode.cpp:183-226): the fields JAX resets, and only
        those."""
        st = self.states
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        freqs = torch.as_tensor(np.asarray(freqs, np.float32),
                                device=self.device)

        def put(field, value):
            out = field.clone()
            out[rows] = value
            return out
        self.states = st._replace(
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
