"""Wideband synthesis on the card: audio streams to one complex capture.

Each VFO's signal is made as the port's modulators make it (MSK as real
audio at 24 kS/s, CPM form with the demodulator's precoder; OQPSK as a
complex baseband on a grid of 16 samples per bit, root-raised-cosine
pulses), and then, where the port's test generators upsample with
``resample_poly`` on the host, its spectrum is placed at the VFO's offset
in the spectrum of the whole capture, and one inverse FFT gives the
wideband IQ: ideal band-limited interpolation, and a capture that is
periodic over its length, so a replay in a loop has no seam.  Every bin
offset is exact because the capture lasts a whole number of seconds and
each frequency is a whole number of hertz.

Bins are added one VFO at a time by slices (no ``index_add_``), so the
same seed gives the same capture bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aerobench.ref.design import root_raised_cosine


def msk_audio(bits: np.ndarray, n: int, fs: int, fb: int, freq: float,
              amplitude: float, start: int = 0,
              periodic: bool = False, device="cpu") -> torch.Tensor:
    """Real MSK audio [n] at ``fs``: the bits from sample ``start``,
    zero elsewhere.  The phase ramps +-pi/2 per bit (``msk_modulate``'s
    CPM form and precoder).  ``periodic``: the bits fill the ``n``
    samples exactly and the carrier is moved by under 0.03 Hz so that the
    audio's phase closes over them."""
    bits = np.asarray(bits, np.uint8)
    sps = fs // fb
    t = bits ^ (np.arange(len(bits)) % 2).astype(np.uint8)
    e = np.cumsum(t) % 2
    d = 1 - 2 * e.astype(np.int64)
    quarter = np.concatenate([[0], np.cumsum(d)[:-1]]) % 4
    m = len(bits) * sps
    if periodic:
        assert m == n and start == 0
        freq = freq - (int(np.sum(d)) % 4) / (4.0 * n / fs)
    i = torch.arange(m, dtype=torch.float64, device=device)
    k = torch.div(i, sps, rounding_mode="floor").long()
    dq = torch.as_tensor(d, device=device)[k].double()
    q0 = torch.as_tensor(quarter, device=device)[k].double()
    cyc = freq * i / fs + q0 / 4.0 + dq * (i - k * sps) / (4.0 * sps)
    sig = amplitude * torch.cos(2.0 * math.pi * torch.remainder(cyc, 1.0))
    out = torch.zeros(n, dtype=torch.float32, device=device)
    out[start:start + m] = sig[:n - start].float()
    return out


def oqpsk_train(bits: np.ndarray, n_hi: int, fb: int, start_hi: int,
                device="cpu") -> torch.Tensor:
    """Symbol impulses on the 16-samples-per-bit grid [n_hi], complex:
    bit 2m -> Q symbol m, bit 2m+1 -> I symbol m half a symbol later
    (``oqpsk_modulate``'s layout), from ``start_hi`` plus two symbols;
    indices wrap, so a stream that fills the grid is periodic."""
    bits = np.asarray(bits, np.uint8)
    if len(bits) % 2:
        bits = np.append(bits, 0)
    os_bit, sym = 16, 32
    q = 1.0 - 2.0 * (bits[0::2] < 1)
    i = 1.0 - 2.0 * (bits[1::2] < 1)
    off = start_hi + 2 * sym
    pos = off + np.arange(len(q)) * sym
    train = torch.zeros(n_hi, dtype=torch.complex64, device=device)
    train[torch.as_tensor(pos % n_hi, device=device)] += torch.as_tensor(
        1j * q, dtype=torch.complex64, device=device)
    train[torch.as_tensor((pos + os_bit) % n_hi, device=device)] += (
        torch.as_tensor(i, dtype=torch.complex64, device=device))
    return train


def oqpsk_spectrum(train: torch.Tensor, fb: int, amplitude: float,
                   alpha: float | None = None) -> torch.Tensor:
    """FFT of the pulse-shaped baseband (the train circularly convolved
    with ``oqpsk_modulate``'s 257-tap RRC, centred as ``mode="same"``),
    scaled so that the envelope's peak is ``amplitude``."""
    if alpha is None:
        alpha = 0.6 if fb == 8400 else 1.0
    n = train.shape[-1]
    fs_hi = 16 * fb
    g = root_raised_cosine(alpha, 8 * 32 + 1, fs_hi, fb / 2.0)
    circ = np.zeros(n, np.float64)
    circ[(np.arange(len(g)) - len(g) // 2) % n] = g
    spec = torch.fft.fft(train) * torch.fft.fft(
        torch.as_tensor(circ, dtype=torch.complex64, device=train.device))
    peak = torch.max(torch.abs(torch.fft.ifft(spec)))
    return spec * (amplitude / peak)


class Capture:
    """The spectrum of a complex capture of ``seconds`` x ``fs`` samples,
    built up VFO by VFO, then ``iq(noise, generator)``."""

    def __init__(self, fs: int, seconds: int, device):
        self.fs, self.T = fs, seconds
        self.n = fs * seconds
        self.device = device
        self.W = torch.zeros(self.n, dtype=torch.complex64, device=device)

    def _add(self, at: int, values: torch.Tensor) -> None:
        """W[at + k] += values[k], k = 0.. len-1, indices mod n."""
        at %= self.n
        m = values.shape[0]
        first = min(m, self.n - at)
        self.W[at:at + first] += values[:first]
        if first < m:
            self.W[:m - first] += values[first:]

    def add_real_audio(self, audio: torch.Tensor, fs_audio: int,
                       offset_hz: int) -> None:
        """A real audio stream [fs_audio x seconds] as the wideband
        component audio(t) exp(2j pi offset t)."""
        n_a = audio.shape[-1]
        assert n_a == fs_audio * self.T
        A = torch.fft.rfft(audio.to(torch.float32)) * (self.n / n_a)
        half = n_a // 2
        at = offset_hz * self.T
        self._add(at, A[:half])                          # k = 0 .. half-1
        neg = torch.conj(torch.flip(A[1:half], dims=[0]))  # k = -(half-1)..-1
        self._add(at - (half - 1), neg)

    def add_baseband(self, spec: torch.Tensor, fs_hi: int, offset_hz: int,
                     carrier_hz: float, band_hz: float) -> None:
        """A complex baseband x on an ``fs_hi`` grid (its FFT ``spec``)
        carried as real audio Re(x exp(2j pi carrier t)) at the VFO's
        offset: x at offset + carrier, conj(x) at offset - carrier, each
        at half amplitude, over +-band_hz of x's spectrum."""
        n_hi = spec.shape[-1]
        assert n_hi == fs_hi * self.T
        kb = int(band_hz * self.T)
        k = torch.arange(-kb, kb + 1, device=spec.device)
        X = spec[k % n_hi] * (0.5 * self.n / n_hi)
        c = int(round(carrier_hz * self.T))
        self._add(offset_hz * self.T + c - kb, X)
        Xc = torch.conj(spec[(-k) % n_hi]) * (0.5 * self.n / n_hi)
        self._add(offset_hz * self.T - c - kb, Xc)

    def iq(self, noise: float, gen: torch.Generator) -> torch.Tensor:
        """The capture in time, plus complex Gaussian noise of ``noise``
        RMS per component; frees the spectrum."""
        x = torch.fft.ifft(self.W)
        self.W = None
        z = torch.randn((2, self.n), generator=gen, device=self.device,
                        dtype=torch.float32)
        x += torch.complex(z[0], z[1]) * noise
        return x
