"""Coarse carrier-frequency estimation via the fold-spectrum method (torch).

Counterpart of ``aero_tpu/models/coarse_freq.py`` (``coarse_freq_init``,
``coarse_freq_estimate``): frequency-domain brick-wall low-pass, squaring,
a smoothed dB spectrum, then a 3-bin fold at the +-fb/2 tone spacing and an
argmax inside the locking bandwidth.  Batched over the leading axes.

The FFTs are ``torch.fft`` on complex64 (cuFFT on the card, pocketfft on
the CPU); both sum in another order than JAX's CPU FFT, so the spectrum
agrees to float32 error and the fold argmax can flip on a near-tie.  The
parity tests compare it teacher-forced (the same carry into both).
"""

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


def spectrum_snapshot(y_state, nbins: int = 256):
    """Decimated smoothed dB fold spectrum (max over groups of nfft/nbins
    bins) for displays and telemetry."""
    nfft = y_state.shape[-1]
    step = nfft // nbins
    return torch.amax(y_state[..., : nbins * step].reshape(
        y_state.shape[:-1] + (nbins, step)), dim=-1)


def spectrum_display(coarse_y, fs: float, nbins: int = 256):
    """(freqs_hz, dB) numpy display arrays from the smoothed fold-spectrum
    carry (numpy or tensor): frequencies are signal offsets relative to
    the current tune (the squared-signal axis halved)."""
    import numpy as _np
    y = spectrum_snapshot(torch.as_tensor(coarse_y), nbins).cpu().numpy()
    nfft = coarse_y.shape[-1]
    step = nfft // nbins
    hzperbin = fs / nfft
    freqs = ((_np.arange(nbins) + 0.5) * step - nfft / 2) * hzperbin * 0.5
    return freqs.astype(_np.float32), y
