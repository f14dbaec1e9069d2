"""Burst MSK demodulator (600/1200 bps Aero R/T channels), torch.

Counterpart of ``aero_tpu/models/burst_msk.py``; read that module's
docstring for the design (window-based bursts: a dense detection step over
blocks, then each detected burst demodulated statelessly as one
fixed-size window by the continuous-MSK pipeline).

The window function takes one window [W] (and its gate [W]) as tensors on
one device and runs there; the continuous demodulator's batched helpers
(``_tone_pair_sync``, ``_interp``, ``_diffdecode``) see it as a batch of
one row.  ``jnp.convolve(mode="same")`` with the even-length kernels
(``8*sps``, the envelope smoothing) is ``ops/fir.py:convolve_same``,
which keeps numpy's alignment.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from aero_tpu_torch.ops.fir import convolve_same, fir_apply, fir_init
from aero_tpu_torch.ops.nco import cis, nco_mix
from aero_tpu_torch.models.msk import (_diffdecode, _interp, _mf_taps,
                                       _soft_bytes, _tone_pair_sync)
from aero_tpu_torch.models.burst_common import BurstWindowDemodulator, _box


class BurstMskConfig(NamedTuple):
    fs: float
    fb: float
    sps: int
    block_len: int
    window_len: int            # demod window (static shape)
    nfft: int
    lockingbw: float
    freq_center: float
    gate_ratio: float
    fine_span_hz: float
    fine_step_hz: float


def make_config(fs: float, fb: float, block_len: int = 16000,
                window_len: int | None = None,
                lockingbw: float = 10500.0, freq_center: float | None = None,
                nfft: int = 8192, gate_ratio: float = 2.5,
                fine_span_hz: float | None = None,
                fine_step_hz: float = 0.5) -> BurstMskConfig:
    sps = int(fs / fb)
    if window_len is None:
        window_len = 3 * block_len
    assert window_len % (2 * sps) == 0
    lockingbw = min(lockingbw, fs / 2.0 - 2 * fb)
    if freq_center is None:
        freq_center = fs / 4.0
    if fine_span_hz is None:
        fine_span_hz = 2.0 * fs / nfft + 4.0
    return BurstMskConfig(fs, fb, sps, block_len, window_len, nfft,
                          lockingbw, freq_center, gate_ratio, fine_span_hz,
                          fine_step_hz)


# ---------------------------------------------------------------------------
# phase 1: detection
# ---------------------------------------------------------------------------

def _envelope(samples, smooth: int):
    """Smoothed power: samples [n] tensor -> [n] on the same device."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    return convolve_same(x * x, _box(smooth, x.device))


# ---------------------------------------------------------------------------
# phase 2: stateless window demodulation
# ---------------------------------------------------------------------------

def _gated_coarse_offset(bb, gate, nfft, fb, fs, lockingbw):
    """One-shot fold-spectrum CFO over the gated baseband bb [B, W] (the
    fold of models/coarse_freq, no cross-block smoothing).  Returns [B]."""
    x = (bb * gate)[..., :nfft]
    hzperbin = fs / nfft
    startbin = max(int(round(lockingbw / hzperbin)), 1)
    epb = int(round(fb / (2.0 * hzperbin)))
    bins = torch.arange(nfft, device=bb.device)
    keep = (bins < startbin) | (bins > nfft - startbin)
    X = torch.fft.fft(x, dim=-1) * keep.to(torch.complex64)
    sq = torch.fft.ifft(X, dim=-1) ** 2
    S = torch.abs(torch.fft.fftshift(torch.fft.fft(sq, dim=-1), dim=-1))
    db = 10.0 * torch.log10(torch.clamp(S, min=1.0))
    tot = torch.zeros_like(db)
    for j in (-1, 0, 1):
        tot = tot + torch.roll(db, epb + j, -1) + torch.roll(db, -(epb + j), -1)
    mid = nfft // 2
    span = int(round(lockingbw / hzperbin))
    inwin = (bins >= mid - span) & (bins < mid + span)
    loc = torch.argmax(torch.where(inwin, tot, torch.full_like(tot, -math.inf)),
                       dim=-1)
    return (loc - mid).to(torch.float32) * hzperbin * 0.5


def _window_front_end(samples, gate, cfg, freq_center, taps):
    """The part both burst window demodulators share, on one window.

    samples, gate: [W] tensors on one device; ``taps`` the matched filter.
    Dilates the gate by the 8*sps smoothing length, mixes by
    ``freq_center``, removes the gated coarse offset, filters, normalizes
    the gated mean magnitude to sqrt(2) and clips at 2.84.  Returns
    (gate [1, W], dfc [1], y [1, W] complex64)."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    dev = x.device
    W = x.shape[-1]
    gate = torch.as_tensor(gate, dtype=torch.float32, device=dev)[None]
    gate = (convolve_same(gate, torch.ones(8 * cfg.sps, dtype=torch.float32,
                                           device=dev)) > 0).to(torch.float32)
    fc = torch.tensor([float(freq_center)], dtype=torch.float32, device=dev)
    _, bb = nco_mix(torch.zeros(1, dtype=torch.float32, device=dev),
                    x[None].to(torch.complex64), fc / cfg.fs, conj=True)
    dfc = _gated_coarse_offset(bb, gate, cfg.nfft, cfg.fb, cfg.fs,
                               cfg.lockingbw)
    n = torch.arange(W, dtype=torch.float32, device=dev)
    bb = bb * cis((-2.0 * math.pi) * (dfc / cfg.fs)[:, None] * n)
    ntaps = taps.shape[0]
    _, y = fir_apply(fir_init(ntaps, (1,), torch.complex64, dev), bb, taps)
    gsum = torch.clamp(torch.sum(gate, dim=-1), min=1.0)
    gmean = torch.sum(torch.abs(y) * gate, dim=-1) / gsum
    y = y * (math.sqrt(2.0) / torch.clamp(gmean, min=1e-6))[:, None]
    mag = torch.abs(y)
    y = torch.where(mag > 2.84, y * (2.84 / torch.clamp(mag, min=1e-9)), y)
    return gate, dfc, y


def burst_msk_window(samples, gate, cfg: BurstMskConfig, freq_center=None):
    """Demodulate one burst window [W] with its sample gate [W] (tensors
    on one device; the work runs there).

    ``freq_center`` overrides cfg.freq_center (a signal hunter's retune).
    Returns a dict of tensors: soft [n_strobes, 2] float, active
    [n_strobes] bool, freq_offset and tone_quality (0-dim)."""
    if freq_center is None:
        freq_center = cfg.freq_center
    sps = cfg.sps
    W = cfg.window_len
    x = torch.as_tensor(samples, dtype=torch.float32)
    dev = x.device
    gate, dfc, y = _window_front_end(x, gate, cfg, freq_center,
                                    _mf_taps(sps, dev))

    df, theta0, t0_bits, quality = _tone_pair_sync(
        y * gate, cfg.fb / cfg.fs,
        cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)

    n = torch.arange(W, dtype=torch.float32, device=dev)
    yr = y * cis(-(theta0[:, None] + 2.0 * math.pi * df[:, None] * n))

    n_strobes = W // (2 * sps)
    m = torch.arange(n_strobes, dtype=torch.float32, device=dev)

    def strobes(g):
        # m * 2sps is exact in float32, so no rounding question here
        pos = g[:, None] + m * (2.0 * sps)
        cur = _interp(yr, torch.clamp(pos, 0, W - 2))
        dly = _interp(yr, torch.clamp(pos - sps, 0, W - 2))
        gt = _interp(gate, torch.clamp(pos, 0, W - 2))
        return cur, dly, gt

    g_raw = torch.remainder(t0_bits * sps, sps)
    cand = (g_raw, g_raw + sps)

    def eye_mse(g):
        pc, pd, gt = strobes(g)
        tda = (torch.abs(pc.real * 0.75) - 1.0) * gt
        tdb = (torch.abs(pd.imag * 0.75) - 1.0) * gt
        return torch.sum(tda * tda + tdb * tdb, dim=-1) / torch.clamp(
            torch.sum(gt, dim=-1), min=1.0)

    grid = torch.where(eye_mse(cand[0]) <= eye_mse(cand[1]), cand[0], cand[1])
    pts_cur, pts_del, gt = strobes(grid)
    start = torch.full((1,), -1.0, dtype=torch.float32, device=dev)
    ob_im, _ = _diffdecode(pts_del.imag, start)
    ob_re, _ = _diffdecode(pts_cur.real, start)
    soft = torch.stack([_soft_bytes(ob_im), _soft_bytes(-ob_re)], dim=-1)
    return {
        "soft": soft[0],
        "active": (gt > 0.5)[0],
        "freq_offset": (dfc + df * cfg.fs)[0],
        "tone_quality": quality[0],
    }


class BurstMskDemodulator(BurstWindowDemodulator):
    """Host wrapper: detection over blocks + per-burst window demod, with
    the window functions and detection statistics on ``device``."""

    def __init__(self, fs: float, fb: float, device="cuda", **kw):
        super().__init__(make_config(fs, fb, **kw), burst_msk_window,
                         device=device)
