"""Frozen plain copy of the filter designs of
``aero_tpu_torch/ops/design.py``, part of the benchmark's reference:
plain PyTorch, run eagerly, importing nothing of the port. The port may
change; this copy does not."""

from __future__ import annotations

import numpy as np

# Halfband decimator coefficient sets (odd-length symmetric, zero even taps,
# 0.5 center).  Values are the reference's tables
# (publish/halfbanddecimator.h:22-93) — numeric filter data, not code.
HALFBAND_TAPS = {
    11: np.array(
        [0.0060431029837374152, 0.0, -0.049372515458761493, 0.0,
         0.29332944952052842, 0.5, 0.29332944952052842, 0.0,
         -0.049372515458761493, 0.0, 0.0060431029837374152],
        dtype=np.float64),
    15: np.array(
        [-0.001442203300285281, 0.0, 0.013017512802724852, 0.0,
         -0.061653278604903369, 0.0, 0.30007792316024057, 0.5,
         0.30007792316024057, 0.0, -0.061653278604903369, 0.0,
         0.013017512802724852, 0.0, -0.001442203300285281],
        dtype=np.float64),
    23: np.array(
        [-0.00014987651418332164, 0.0, 0.0014748633283609852, 0.0,
         -0.0074416944990005314, 0.0, 0.026163522731980929, 0.0,
         -0.077593699116544707, 0.0, 0.30754683719791986, 0.5,
         0.30754683719791986, 0.0, -0.077593699116544707, 0.0,
         0.026163522731980929, 0.0, -0.0074416944990005314, 0.0,
         0.0014748633283609852, 0.0, -0.00014987651418332164],
        dtype=np.float64),
}


def _window(kind: str, n: int) -> np.ndarray:
    m = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * m / (n - 1))
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * m / (n - 1))
    if kind == "blackman":
        return (0.42 - 0.5 * np.cos(2 * np.pi * m / (n - 1))
                + 0.08 * np.cos(4 * np.pi * m / (n - 1)))
    raise ValueError(f"unknown window {kind!r}")


_MAX_ATTEN = {"hamming": 53.0, "hann": 44.0, "blackman": 74.0}


def low_pass_design(gain: float, fs: float, cutoff: float,
                    transition_width: float, window: str = "hamming",
                    ntaps: int | None = None) -> np.ndarray:
    """Windowed-sinc low-pass, same tap rule as the reference channelizer.

    ntaps = attenuation * fs / (22 * transition_width), forced odd
    (ref: publish/firfilter.cpp:91-99); taps are sin(n*w0)/(n*pi) * window,
    normalized to unit DC gain (ref: publish/firfilter.cpp:58-88).
    """
    if ntaps is None:
        ntaps = int(_MAX_ATTEN[window] * fs / (22.0 * transition_width))
        if ntaps % 2 == 0:
            ntaps += 1
    m = (ntaps - 1) // 2
    w = _window(window, ntaps)
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2 * np.pi * cutoff / fs
    taps = np.where(n == 0, fw / np.pi, np.sin(n * fw) / np.where(n == 0, 1.0, n * np.pi))
    taps = taps * w
    taps *= gain / np.sum(taps)
    return taps


def root_raised_cosine(alpha: float, ntaps: int, fs: float, symbol_rate: float) -> np.ndarray:
    """Closed-form RRC taps (ref: decode/DSP.h:323-353, forced odd length)."""
    if ntaps % 2 == 0:
        ntaps += 1
    T = fs / symbol_rate
    mid = (ntaps - 1) / 2.0
    taps = np.empty(ntaps, dtype=np.float64)
    for i in range(ntaps):
        if i == (ntaps - 1) // 2:
            taps[i] = (4.0 * alpha + np.pi - np.pi * alpha) / (np.pi * np.sqrt(T))
            continue
        fi = i - mid
        denom = 1.0 - (4.0 * alpha * fi / T) ** 2
        if abs(denom) < 1e-10:
            taps[i] = (alpha * ((np.pi - 2.0) * np.cos(np.pi / (4 * alpha))
                                + (np.pi + 2.0) * np.sin(np.pi / (4 * alpha)))
                       / (np.pi * np.sqrt(2.0 * T)))
        else:
            taps[i] = (4.0 * alpha / (np.pi * np.sqrt(T))
                       * (np.cos((1 + alpha) * np.pi * fi / T)
                          + T / (4 * alpha * fi) * np.sin((1 - alpha) * np.pi * fi / T))
                       / denom)
    return taps


def msk_matched_filter(sps: int) -> np.ndarray:
    """Half-sine MSK matched filter over 2*sps samples.

    h[i] = sin(pi i / (2 sps)) / (2 sps)   (ref: decode/mskdemodulator.cpp:25-32)
    """
    i = np.arange(2 * sps, dtype=np.float64)
    return np.sin(np.pi * i / (2.0 * sps)) / (2.0 * sps)


def hilbert_design(ntaps: int = 125) -> np.ndarray:
    """Odd-length type-III FIR Hilbert transformer (windowed ideal response).

    Used by the channelizer's USB demod (ref: publish/dsp.cpp:181-215).
    """
    if ntaps % 2 == 0:
        ntaps += 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n % 2 != 0, 2.0 / (np.pi * n), 0.0)
    h[m] = 0.0
    h *= np.blackman(ntaps)
    return h
