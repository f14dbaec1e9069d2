"""Spectral helpers: single-bin DFTs and tone trackers (torch).

Counterpart of ``aero_tpu/ops/spectral.py``: each block extracts a tone
with one dense single-bin DFT, an O(T) reduction over the last axis that
batches over any leading (VFO) axes.
"""

from __future__ import annotations

import math

import torch

from aero_tpu_torch.ops.nco import cis


def single_bin_dft(x, freq_norm):
    """DFT of x [..., T] at normalized frequency f/Fs (cycles/sample):
    sum(x[n] * exp(-2j pi f n)).  ``freq_norm`` broadcasts against the
    leading axes; the phase is wrapped in cycles (floor-mod) before the
    exp, as in the JAX version."""
    T = x.shape[-1]
    n = torch.arange(T, dtype=torch.float32, device=x.device)
    f = torch.as_tensor(freq_norm, dtype=torch.float32, device=x.device)
    ang = -2.0 * math.pi * torch.remainder(f[..., None] * n, 1.0)
    return torch.sum(x * cis(ang), dim=-1)


def tone_phase_and_freq(x, freq_norm, halfspan_bins: int = 1):
    """Phase of a known tone near ``freq_norm`` in x [..., T].

    Evaluates 2*halfspan+1 candidate bins one DFT bin apart around the
    nominal frequency, picks the strongest, and returns (phase_cycles,
    refined_freq_norm, magnitude)."""
    T = x.shape[-1]
    offs = torch.arange(-halfspan_bins, halfspan_bins + 1,
                        dtype=torch.float32, device=x.device) / T
    f = torch.as_tensor(freq_norm, dtype=torch.float32, device=x.device)
    cands = torch.broadcast_to(f[..., None] + offs,
                               x.shape[:-1] + offs.shape)     # [..., C]
    coeffs = torch.stack([single_bin_dft(x, cands[..., i])
                          for i in range(offs.shape[0])], dim=-1)
    best = torch.argmax(torch.abs(coeffs), dim=-1, keepdim=True)
    coeff = torch.take_along_dim(coeffs, best, dim=-1)[..., 0]
    fbest = torch.take_along_dim(cands, best, dim=-1)[..., 0]
    phase = torch.angle(coeff) / (2.0 * math.pi)
    return phase, fbest, torch.abs(coeff)
