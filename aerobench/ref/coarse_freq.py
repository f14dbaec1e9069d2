"""Frozen plain copy of the coarse frequency search of
``aero_tpu_torch/models/coarse_freq.py``, part of the benchmark's
reference: plain PyTorch, run eagerly, importing nothing of the port.
The port may change; this copy does not."""

from __future__ import annotations

import functools

import torch


def coarse_freq_init(nfft: int, batch_shape=(), device="cpu"):
    """Smoothed-dB-spectrum carry, flooded high like bigchange()
    (ref: coarsefreqestimate.cpp:83-87)."""
    return torch.full(batch_shape + (nfft,), 20.0, dtype=torch.float32,
                      device=device)


@functools.lru_cache(maxsize=None)
def _masks(nfft: int, startbin: int, span: int, device):
    bins = torch.arange(nfft, device=device)
    keep = ((bins < startbin) | (bins > nfft - startbin)).to(torch.complex64)
    mid = nfft // 2
    inwin = (bins >= mid - span) & (bins < mid + span)
    return keep, inwin


def coarse_freq_estimate(y_state, x, *, nfft: int, fb: float, fs: float,
                         lockingbw: float):
    """x: complex baseband [..., T] with T >= nfft (first nfft samples used).

    Returns (new_y_state, freq_offset_hz [...])."""
    x = x[..., :nfft]
    hzperbin = fs / nfft
    startbin = max(int(round(lockingbw / hzperbin)), 1)
    epb = int(round(fb / (2.0 * hzperbin)))
    span = int(round(lockingbw / hzperbin))
    keep, inwin = _masks(nfft, startbin, span, x.device)

    X = torch.fft.fft(x, dim=-1) * keep
    xlp = torch.fft.ifft(X, dim=-1)
    sq = xlp * xlp
    S = torch.fft.fftshift(torch.fft.fft(sq, dim=-1), dim=-1)

    # scale-invariant dB spectrum (peak-normalized, floored 40 dB down)
    mag = torch.abs(S)
    ref = torch.amax(mag, dim=-1, keepdim=True)
    db = 10.0 * torch.log10(torch.clamp(mag / torch.clamp(ref, min=1e-30),
                                        min=1e-4))
    y = y_state * 0.7 + 0.3 * db

    # fold at +-expectedpeakbin with a 3-bin sum (ref: :119-141)
    z = torch.zeros_like(y)
    for j in (-1, 0, 1):
        lo = torch.roll(y, epb + j, dims=-1)      # y[i - (epb+j)]
        hi = torch.roll(y, -(epb + j), dims=-1)   # y[i + (epb+j)]
        z = z + lo + hi

    z = torch.where(inwin, z, torch.full_like(z, -torch.inf))
    loc = torch.argmax(z, dim=-1)
    est = (loc - nfft // 2).to(torch.float32) * hzperbin * 0.5
    return y, est
