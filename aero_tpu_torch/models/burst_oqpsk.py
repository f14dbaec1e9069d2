"""Burst OQPSK demodulator (10500 bps C-band R/T channels), torch.

Counterpart of ``aero_tpu/models/burst_oqpsk.py``: each detected burst is
demodulated as one stateless window (gated coarse CFO in-window, RRC
matched filter, masked tone-pair sync, OQPSK strobe pairing, straight soft
mapping); detection is ``models/burst_common.py``.  The window [W] runs on
the device of its tensors, as a batch of one row for the shared helpers.

Output protocol: int16 stream, -1 start-of-burst marker, soft pairs
[Q (imag), I (real)] per symbol, for ``protocol/rt_framing`` with
``oqpsk=True``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from aero_tpu_torch.ops.nco import cis, fused_mul_add
from aero_tpu_torch.models.msk import _interp, _tone_pair_sync
from aero_tpu_torch.models.oqpsk import _rrc_taps, _soft_bytes
from aero_tpu_torch.models.burst_msk import _window_front_end
from aero_tpu_torch.models.burst_common import BurstWindowDemodulator


class BurstOqpskConfig(NamedTuple):
    fs: float
    fb: float
    sps: int                   # smoothing-length proxy (int samples/bit)
    block_len: int
    window_len: int
    nfft: int
    lockingbw: float
    freq_center: float
    gate_ratio: float
    fine_span_hz: float
    fine_step_hz: float
    alpha: float
    ntaps: int

    @property
    def strobe_step(self) -> float:
        return self.fs / self.fb


def make_config(fs: float, fb: float, block_len: int = 16000,
                window_len: int | None = None, lockingbw: float = 10500.0,
                freq_center: float = 8000.0, nfft: int = 8192,
                gate_ratio: float = 2.5, fine_span_hz: float | None = None,
                fine_step_hz: float = 0.5) -> BurstOqpskConfig:
    if window_len is None:
        window_len = 3 * block_len
    lockingbw = min(lockingbw, fs / 2.0 - fb)
    if fine_span_hz is None:
        fine_span_hz = 2.0 * fs / nfft + 4.0
    return BurstOqpskConfig(fs, fb, max(1, int(fs / fb)), block_len,
                            window_len, nfft, lockingbw, freq_center,
                            gate_ratio, fine_span_hz, fine_step_hz,
                            0.6 if fb == 8400 else 1.0, 55)


def burst_oqpsk_window(samples, gate, cfg: BurstOqpskConfig,
                       freq_center=None):
    """Demodulate one burst window [W] with its sample gate [W] (tensors
    on one device).  Returns soft [n_pairs, 2] float (Q, I), active
    [n_pairs] bool, freq_offset and tone_quality (0-dim tensors)."""
    if freq_center is None:
        freq_center = cfg.freq_center
    W = cfg.window_len
    step = cfg.strobe_step
    x = torch.as_tensor(samples, dtype=torch.float32)
    dev = x.device
    gate, dfc, y = _window_front_end(
        x, gate, cfg, freq_center,
        _rrc_taps(cfg.alpha, cfg.ntaps, cfg.fs, cfg.fb, dev))

    df, theta0, t0_sym, quality = _tone_pair_sync(
        y * gate, cfg.fb / cfg.fs,
        cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)

    n = torch.arange(W, dtype=torch.float32, device=dev)
    yr = y * cis(-(theta0[:, None] + 2.0 * math.pi * df[:, None] * n))

    n_pairs = int(W // (2 * step))
    m = torch.arange(n_pairs, dtype=torch.float32, device=dev)

    def pair_points(g):
        # g + m * 2step with one rounding, as the JAX version on the CPU
        pos_q = fused_mul_add(m, 2.0 * step, g[:, None])
        q = _interp(yr, pos_q).imag
        i = _interp(yr, pos_q + step).real
        gt = _interp(gate, pos_q)
        return i, q, gt

    g_raw = torch.remainder(t0_sym * (2.0 * step), 2.0 * step)
    cand = (g_raw, torch.remainder(g_raw + step, 2.0 * step))

    def eye_mse(g):
        i, q, gt = pair_points(g)
        den = torch.clamp(torch.sum(gt, dim=-1), min=1.0)
        mean_mag = torch.sum(torch.sqrt(i * i + q * q) * gt, dim=-1) / den
        s = (math.sqrt(2.0) / torch.clamp(mean_mag, min=1e-6))[:, None]
        tda = (torch.abs(i * s) - 1.0) * gt
        tdb = (torch.abs(q * s) - 1.0) * gt
        return torch.sum(tda * tda + tdb * tdb, dim=-1) / den

    grid = torch.where(eye_mse(cand[0]) <= eye_mse(cand[1]), cand[0], cand[1])
    pt_i, pt_q, gt = pair_points(grid)
    soft = torch.stack([_soft_bytes(pt_q), _soft_bytes(pt_i)], dim=-1)
    return {
        "soft": soft[0],
        "active": (gt > 0.5)[0],
        "freq_offset": (dfc + df * cfg.fs)[0],
        "tone_quality": quality[0],
    }


class BurstOqpskDemodulator(BurstWindowDemodulator):
    """Host wrapper: detection over blocks + per-burst window demod, with
    the window functions and detection statistics on ``device``."""

    def __init__(self, fs: float, fb: float, device="cuda", **kw):
        super().__init__(make_config(fs, fb, **kw), burst_oqpsk_window,
                         device=device)
