"""The reference of the fused station's device step on the 4x filterbank
plan (``FusedStation(pfb_oversample=4)``), plain PyTorch.

``ref.step``'s ``RefStation`` with the plan overridden and nothing else:
K = 4*fs/out_rate bins (12 kHz apart at 48 kS/s from 1.536 MS/s), hop M
= K/4, so the channel rate, the block, the demodulators and the wire
layout stay ``step``'s; the prototype is this file's own copy of the 4x
design (``prototype``), each VFO's bin and residual follow the new
bins, and each residual mix starts at the phase of the filterbank's
delay, L/2 - M input samples from the prototype's centre tap to its
frame's last sample (``phase0``): d Hz from the bin's centre, a VFO's
carrier leaves the filterbank turned by 2 pi d (L/2 - M) / fs against a
mixer at the VFO on the input's clock, and the real audio of a signal on
both sides of the VFO would scale by the cosine of that angle.  A burst
OQPSK watcher's audio is low-passed to its band before the int16
conversion and scaled by 1/(2M), the filterbank's channel gain undone
(``watcher_taps``, with a carry of its last 62 samples in the group's
state as "chan").  The rest of the per-group body of ``_step`` (demods,
hunter, packing) is ``step``'s, copied, since ``step`` computes the
channelizer inline.

The channelizer is the plain WOLA of ``channelize``: frame m at hop m,
reversed prototype, the P-fold sum, a K-point FFT and the twiddle.  One
departure from its unfold form, needed to stay exact against the
station: the fold of a block with a whole number of hops of each parity
is computed as the station computes it, one grouped convolution over the
real and imaginary rows of the four hop parities (``channelize_fused``),
so that cuDNN sums the same products in the same order on the card;
``channelize`` equals it to float32 rounding (a test on the CPU).
Float32, TF32 off (``precision="fp32"``); imports nothing of the program
or of JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from aerobench.ref import msk as _msk
from aerobench.ref import step
from aerobench.ref.nco import cis, fused_mul_add
from aerobench.ref.pfb import pfb_bin_for_freq

OVERSAMPLE = 4
TAPS_PER_BRANCH = 8
KAISER_BETA = 10.0


@functools.lru_cache(maxsize=None)
def prototype(K: int, P: int = TAPS_PER_BRANCH) -> np.ndarray:
    """The 4x plan's prototype lowpass, P*K taps: a Kaiser-windowed sinc
    (beta 10) of P*K - 1 taps with a zero appended, cutoff at the
    channel's Nyquist fs/(2M) = 2 bins, DC gain 2M = K/2.  It passes
    1.525 bins (a VFO half a bin off its bin's centre plus a 13.3 kHz
    band at 12 kHz bins) within 1e-4 dB and stops by 2.475 bins (where
    the first alias of that band lands) by 100 dB."""
    L = P * K
    n = np.arange(L - 1) - (L - 2) / 2.0
    cut = 2.0 / K
    taps = 2.0 * cut * np.sinc(2.0 * cut * n) * np.kaiser(L - 1, KAISER_BETA)
    taps = np.append(taps, 0.0)
    return (taps / np.sum(taps) * (K // 2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(K: int, F_hops: int, device):
    """Reversed prototype [P*K], fold weights [K, 1, P], twiddle [F, K]
    (angle fl(-2pi * k*r) / K in float32, r = ((m+1)*M) % K)."""
    M = K // OVERSAMPLE
    P = TAPS_PER_BRANCH
    hrev = np.ascontiguousarray(prototype(K)[::-1])
    w = np.ascontiguousarray(hrev.reshape(P, K).T[:, None, :])
    m = np.arange(F_hops, dtype=np.int64)
    k = np.arange(K, dtype=np.int64)
    kr = (k[None, :] * (((m[:, None] + 1) * M) % K)).astype(np.float32)
    ang = (np.float32(-2.0 * np.pi) * kr) / np.float32(K)
    tw = np.exp(1j * ang.astype(np.float64)).astype(np.complex64)
    return (torch.from_numpy(hrev).to(device), torch.from_numpy(w).to(device),
            torch.from_numpy(tw).to(device))


WATCHER_TAPS = 63


@functools.lru_cache(maxsize=None)
def watcher_taps(out_rate: float, M: int, device) -> torch.Tensor:
    """The burst OQPSK watcher's low-pass, conv1d weights [1, 1, 63]: a
    Kaiser-windowed sinc (beta 7.5) cut at 15.4 kHz, DC gain 1/(2M) (the
    filterbank's channel gain undone); at 48 kS/s it passes 13.25 kHz
    (8 kHz carrier and the 5.25 kHz half band) within 1e-3 dB and stops
    from 17.5 kHz by 78 dB."""
    n = np.arange(WATCHER_TAPS) - (WATCHER_TAPS - 1) / 2.0
    fc = 15400.0 / out_rate
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.kaiser(WATCHER_TAPS, 7.5)
    h = (h / np.sum(h) / (2 * M)).astype(np.float32)
    return torch.from_numpy(h[None, None, :]).to(device)


def init(K: int, device) -> torch.Tensor:
    """The filterbank carry: the last L - M input samples."""
    return torch.zeros(TAPS_PER_BRANCH * K - K // OVERSAMPLE,
                       dtype=torch.complex64, device=device)


def channelize(state, x, K: int):
    """(carry, block [T]) -> (carry, z [K, T/M]), the plain form."""
    M = K // OVERSAMPLE
    L = TAPS_PER_BRANCH * K
    F_hops = x.shape[-1] // M
    hrev, _, tw = _tables(K, F_hops, x.device)
    xp = torch.cat([state, x])
    frames = xp.unfold(0, L, M)[:F_hops]
    folded = (frames * hrev).reshape(F_hops, TAPS_PER_BRANCH, K).sum(dim=1)
    z = torch.fft.fft(folded, dim=-1) * tw
    return xp[-(L - M):], z.T.contiguous()


def channelize_fused(state, x, K: int):
    """``channelize`` with the fold as the station computes it: frames at
    hops 4q + p start at row q of the stream from p*M on, so the fold is
    one P-tap grouped convolution over the 8 real rows (parity x
    real/imag)."""
    M = K // OVERSAMPLE
    P = TAPS_PER_BRANCH
    L = P * K
    F_hops = x.shape[-1] // M
    _, w, tw = _tables(K, F_hops, x.device)
    xp = torch.cat([state, x])
    Q = F_hops // OVERSAMPLE
    planes = []
    for p in range(OVERSAMPLE):
        rows = xp[p * M: p * M + (Q + P - 1) * K].reshape(Q + P - 1, K)
        planes += [rows.real, rows.imag]
    y = F.conv1d(torch.stack(planes).transpose(1, 2), w, groups=K)
    folded = torch.stack([torch.complex(y[2 * p], y[2 * p + 1]).T
                          for p in range(OVERSAMPLE)],
                         dim=1).reshape(F_hops, K)
    z = torch.fft.fft(folded, dim=-1) * tw
    return xp[-(L - M):], z.T.contiguous()


class RefStation(step.RefStation):
    """``step.RefStation`` on the 4x plan."""

    def __init__(self, vfos, fs: int, ingest_dtype: str = "int4",
                 hunt: bool = True, device="cpu", precision: str = "fp32"):
        # step's channel rates, block, demodulators and layout: the hop
        # (K/2 there, K/4 here) is the same, so only the bins change
        super().__init__(vfos, fs, ingest_dtype, hunt, device, precision)
        self.K = {r: OVERSAMPLE * fs // r for r in self.K}
        self.phase0 = {}
        for key, idxs in self.groups.items():
            K = self.K[key[0]]
            delay = TAPS_PER_BRANCH * K // 2 - K // OVERSAMPLE
            bins, resid, phase0 = [], [], []
            for i in idxs:
                delta = vfos[i][1]
                k = pfb_bin_for_freq(delta, fs, K)
                kc = k if k < K // 2 else k - K
                bins.append(k)
                resid.append(-(delta - kc * fs / K) / key[0])
                phase0.append(((delta - kc * fs / K) * delay / fs) % 1.0)
            self.phase0[key] = torch.as_tensor(np.asarray(phase0, np.float32),
                                               device=self.device)
            self.params[key] = (
                torch.as_tensor(np.asarray(bins, np.int64),
                                device=self.device),
                torch.as_tensor(np.asarray(resid, np.float32),
                                device=self.device))

    def init_state(self) -> dict:
        st = super().init_state()
        st["pfb"] = {r: init(K, self.device) for r, K in self.K.items()}
        for key, g in st["grp"].items():
            g["phase"] = self.phase0[key].clone()
            if key[2] and key[1] > 1200:
                g["chan"] = torch.zeros(len(self.groups[key]),
                                        WATCHER_TAPS - 1, dtype=torch.float32,
                                        device=self.device)
        return st

    def adopt(self, tree) -> dict:
        st = super().adopt(tree)
        for key, g in tree["grp"].items():
            if "chan" in g:
                st["grp"][key]["chan"] = g["chan"].detach().to(
                    self.device).clone()
        return st

    def _step(self, state, q):
        x = self.dequantize(q)
        dev = x.device
        new = {"pfb": {}, "grp": {}}
        z_by = {}
        for r, K in self.K.items():
            chan = (channelize_fused
                    if (x.shape[-1] // (K // OVERSAMPLE)) % OVERSAMPLE == 0
                    else channelize)
            new["pfb"][r], z_by[r] = chan(state["pfb"][r], x, K)
        parts = {}
        for key in self.order:
            bins, resid = self.params[key]
            g = state["grp"][key]
            zb = z_by[key[0]][bins]
            F_len = zb.shape[1]
            n = torch.arange(F_len, dtype=torch.float32, device=dev)
            ramp = fused_mul_add(resid[:, None], n, g["phase"][:, None])
            osc = cis((2.0 * math.pi) * torch.remainder(ramp, 1.0))
            audio = (zb * osc).real.float() * step.GAIN
            ng = {"phase": torch.remainder(fused_mul_add(resid, F_len,
                                                         g["phase"]), 1.0)}
            new["grp"][key] = ng
            if key[2]:
                if "chan" in g:
                    hist = torch.cat([g["chan"], audio], dim=1)
                    ng["chan"] = hist[:, F_len:]
                    audio = F.conv1d(hist[:, None, :], watcher_taps(
                        key[0], self.K[key[0]] // OVERSAMPLE, dev))[:, 0]
                a16 = torch.clamp(torch.round(audio * step.AUDIO_I16_SCALE),
                                  -32767, 32767).to(torch.int16)
                rms = torch.sqrt(torch.mean(audio * audio, dim=1))
                peak = torch.amax(torch.abs(audio), dim=1)
                zero = torch.zeros_like(rms)
                parts[key] = (a16.contiguous().view(torch.uint8),
                              torch.stack([rms, peak, zero, zero, zero]))
                continue
            mod, c = self.dcfg[key]
            stepf = mod.msk_step if mod is _msk else mod.oqpsk_step
            s2, out = stepf(g["demod"], audio, c)
            if "hunt" in g:
                s2, ng["hunt"] = self._hunt(key, s2, out["signal"], g["hunt"])
            ng["demod"] = s2
            parts[key] = (out["soft_bits"], torch.stack(
                [out["signal"].to(torch.float32), out["mse"].float(),
                 out["ebno"].float(), s2.freq.float(),
                 out["slip"].to(torch.float32)]))
        soft = [parts[k][0].to(torch.uint8).reshape(-1) for k in self.order]
        tel = torch.cat([parts[k][1].float().reshape(-1) for k in self.order])
        return new, torch.cat(soft + [tel.contiguous().view(torch.uint8)])
