"""Polyphase (WOLA) filterbank channelizer (torch).

Counterpart of ``aero_tpu/channelizer/pfb.py``: ``pfb_prototype`` (the same
numpy design), ``pfb_init``, ``pfb_channelize``, ``pfb_channelize_fused``,
``pfb_bin_for_freq``, ``pfb_extract_vfo`` and the ``PfbChannelizer``
backend of the classic station.  Channel k of the output is the input mixed down
by k*fs/K, filtered by the prototype and decimated by the hop M:

    z[k, m] = sum_j h[j] x[mM - j] exp(-2j pi k (mM - j) / K)

The state is the last L-M input samples (complex64).  In the fused form
the fold is a depthwise convolution, ``F.conv1d(groups=K)`` over the real
and imaginary rows of each hop parity (cuDNN on the card, held at full
float32).

Two plans, by ``oversample`` = K/M (``pfb_plan``).  The 2x plan is JAX's:
K = 2*fs/out_rate, M = K/2, bins fs/K apart at half the channel rate and
``pfb_prototype``'s passband edge at 0.75 of the bin spacing, so a VFO
more than a quarter bin from its bin's centre loses the outer part of its
band.  The 4x plan (``pfb_prototype_os4``): K = 4*fs/out_rate, M = K/4,
the same channel rate and hops per block, bins a quarter of the channel
rate apart, and a passband that holds a VFO anywhere in its bin with its
band.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.design import low_pass_design
from aero_tpu_torch.ops.nco import cis, fused_mul_add
from aero_tpu_torch.utils.graphs import GraphedStep


@functools.lru_cache(maxsize=None)
def pfb_prototype(K: int, taps_per_branch: int = 8, fs: float = 1.0,
                  cutoff_frac: float = 0.75) -> np.ndarray:
    """Prototype lowpass, length P*K; passband edge at ``cutoff_frac`` of
    the bin spacing fs/K (see the JAX docstring for the choice)."""
    L = taps_per_branch * K
    cut = cutoff_frac / K
    taps = low_pass_design(1.0, 1.0, cut, 0.45 / K, ntaps=L - 1)
    taps = np.append(taps, 0.0)
    return (taps / np.sum(taps) * K).astype(np.float32)


PLANS = (2, 4)          # oversampling factors K/M a plan may take
OS4_BETA = 10.0         # the 4x prototype's Kaiser window


def pfb_plan(fs: float, out_rate: float, oversample: int = 2) -> tuple:
    """(K, M) of the plan that gives channels of ``out_rate`` from a
    wideband stream at ``fs``: K = oversample*fs/out_rate bins, hop M =
    K/oversample.  ``oversample`` is 2 or 4 (ValueError otherwise)."""
    if oversample not in PLANS:
        raise ValueError(f"pfb_oversample {oversample!r}: a filterbank plan "
                         f"oversamples by one of {PLANS}")
    K = int(round(oversample * fs / out_rate))
    assert abs(oversample * fs / out_rate - K) < 1e-9, \
        f"out_rate {out_rate} incompatible with fs {fs}"
    return K, K // oversample


def pfb_delay(K: int, oversample: int = 2, taps_per_branch: int = 8) -> int:
    """Input samples from the centre of the prototype (tap (L-2)/2) to the
    last sample of its frame, L/2 - M: channel k at output m is the input
    mixed down by k*fs/K, filtered, at sample mM + M - 1, so a component
    d Hz from the bin's centre leaves it with the phase -2 pi d delay /
    fs against a mixer at the VFO that runs on the input's clock."""
    return taps_per_branch * K // 2 - K // oversample


@functools.lru_cache(maxsize=None)
def pfb_prototype_os4(K: int, taps_per_branch: int = 8) -> np.ndarray:
    """The 4x plan's prototype lowpass, length P*K, for hop M = K/4.

    Bins lie fs/K apart and the channel rate is fs/M = 4 bins, so a VFO
    lies within half a bin of its bin's centre and its band, B each
    side of it, within 0.5 bin + B of that centre.  The channel is free
    of aliases there if the prototype passes 0.5 bin + B flat and stops
    by 4 bins - (0.5 bin + B), where the first alias lands.  For the C
    band (fs 1.536 MS/s, 48 kS/s channels: K = 128, 12 kHz bins) B is
    13.3 kHz for a P or T channel (OQPSK 10500, RRC alpha 1, at +-8 kHz
    as the station's real audio carries it) and 11.4 kHz for a C channel
    (8400, alpha 0.6): pass to 19.3 kHz (1.608 bins), stop from 28.7 kHz
    (2.392 bins); on the 34 kHz raster every VFO lies within 5 kHz of its
    bin's centre, so 18.3 kHz (1.525 bins) and 29.7 kHz (2.475 bins).

    Design: a windowed sinc of L-1 = P*K - 1 taps (odd, centred) with a
    zero appended, as ``pfb_prototype``; cutoff at the channel's Nyquist,
    fs/(2M) = 2 bins; Kaiser window, beta 10; scaled to a DC gain of 2M,
    the 2x plan's channel gain for the same M.  At P = 8 (every K: the
    design scales with it) the float64 response, relative to DC: ripple
    within +-1e-4 dB to 1.525 bins and +-3e-4 dB to 1.608, -3 dB at 1.93
    bins, at most -88.7 dB from 2.392 bins on and -100.8 dB from 2.475."""
    L = taps_per_branch * K
    n = np.arange(L - 1) - (L - 2) / 2.0
    cut = 2.0 / K
    taps = 2.0 * cut * np.sinc(2.0 * cut * n) * np.kaiser(L - 1, OS4_BETA)
    taps = np.append(taps, 0.0)
    return (taps / np.sum(taps) * (K // 2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(K: int, P: int, F_hops: int, device, oversample: int = 2):
    """Per-device constants: reversed prototype [P*K], depthwise fold
    weights [K, 1, P], and the output twiddle [F, K].

    The twiddle keeps the JAX arithmetic (angle = fl(-2pi * k*r) / K in
    float32, with r = ((m+1)*M) % K): an exactly reduced angle would
    differ from the reference by up to ~3e-5 rad at k*r ~ 16000."""
    M = K // oversample
    h = (pfb_prototype(K, P) if oversample == 2
         else pfb_prototype_os4(K, P))
    hrev = np.ascontiguousarray(h[::-1])
    w = np.ascontiguousarray(hrev.reshape(P, K).T[:, None, :])   # [K, 1, P]
    m = np.arange(F_hops, dtype=np.int64)
    k = np.arange(K, dtype=np.int64)
    kr = (k[None, :] * (((m[:, None] + 1) * M) % K)).astype(np.float32)
    ang = (np.float32(-2.0 * np.pi) * kr) / np.float32(K)
    tw = np.exp(1j * ang.astype(np.float64)).astype(np.complex64)
    return (torch.from_numpy(hrev).to(device), torch.from_numpy(w).to(device),
            torch.from_numpy(tw).to(device))


def pfb_init(K: int, taps_per_branch: int = 8, batch_shape=(),
             device="cpu", oversample: int = 2):
    L = taps_per_branch * K
    M = K // oversample
    return torch.zeros(batch_shape + (L - M,), dtype=torch.complex64,
                       device=device)


def pfb_channelize(state, x, K: int, taps_per_branch: int = 8,
                   oversample: int = 2):
    """x: [T] complex wideband (T % M == 0, M = K // oversample).

    Returns (new_state, z [K, T//M]) — K channels, ``oversample``x
    oversampled, channel k centered at k*fs/K (k > K/2 wraps to
    negative)."""
    M = K // oversample
    P = taps_per_branch
    L = P * K
    T = x.shape[-1]
    F_hops = T // M
    hrev, _, tw = _tables(K, P, F_hops, x.device, oversample)

    xp = torch.cat([state, x])                        # [T + L - M]
    frames = xp.unfold(0, L, M)[:F_hops]              # [F, L], frame m at mM
    folded = (frames * hrev).reshape(F_hops, P, K).sum(dim=1)
    z = torch.fft.fft(folded, dim=-1) * tw
    return xp[-(L - M):], z.T.contiguous()


def pfb_channelize_fused(state, x, K: int, taps_per_branch: int = 8,
                         oversample: int = 2):
    """Equal to ``pfb_channelize`` (M = K // oversample, a whole number of
    hops of each parity): the frames at hops m = o*q + p (o =
    ``oversample``) align to K-sample rows of the stream from p*M on, so
    the fold is a P-tap depthwise convolution along the row axis and each
    wideband sample is read once per parity instead of P times."""
    o = oversample
    M = K // o
    P = taps_per_branch
    L = P * K
    T = x.shape[-1]
    F_hops = T // M
    assert F_hops % o == 0, "need a whole number of hops of each parity"
    _, w, tw = _tables(K, P, F_hops, x.device, o)

    xp = torch.cat([state, x])                        # [T + L - M]
    Q = F_hops // o
    planes = []
    for p in range(o):
        rows = xp[p * M: p * M + (Q + P - 1) * K].reshape(Q + P - 1, K)
        planes += [rows.real, rows.imag]
    # out[q, k] = sum_c hrev[c*K + k] * rows[q + c, k]: one grouped conv
    # over the 2*o real rows (parity x real/imag)
    y = F.conv1d(torch.stack(planes).transpose(1, 2), w,
                 groups=K)                            # [2o, K, Q]
    folded = torch.stack([torch.complex(y[2 * p], y[2 * p + 1]).T
                          for p in range(o)],         # o x [Q, K]
                         dim=1).reshape(F_hops, K)
    z = torch.fft.fft(folded, dim=-1) * tw
    return xp[-(L - M):], z.T.contiguous()


def pfb_bin_for_freq(freq_hz: float, fs: float, K: int) -> int:
    """Nearest bin index for a baseband frequency (may be negative)."""
    return int(np.round(freq_hz / (fs / K))) % K


def pfb_extract_vfo(z_k, phase, residual_norm):
    """Residual-mix one PFB channel to center a VFO exactly.

    z_k: [F] channel samples at rate fs/(K//2); residual_norm = residual
    frequency in cycles per OUTPUT sample.  Returns (new_phase, centered
    complex baseband).  The ramps round once, as XLA's CPU compiler
    contracts ``phase + r*n`` (``ops/nco.py:fused_mul_add``)."""
    F_len = z_k.shape[-1]
    phase, residual_norm = (torch.as_tensor(v, dtype=torch.float32,
                                            device=z_k.device)
                            for v in (phase, residual_norm))
    n = torch.arange(F_len, dtype=torch.float32, device=z_k.device)
    ramp = fused_mul_add(residual_norm, n, phase)
    osc = cis((-2.0 * math.pi) * torch.remainder(ramp, 1.0))
    new_phase = torch.remainder(fused_mul_add(residual_norm, F_len, phase),
                                1.0)
    return new_phase, z_k * osc


def _group_step(state, x, K, bins, resid, gain):
    """One rate group's step: state (filterbank carry [L - M], residual-mix
    phases [n]) and the wideband block x [T] -> (new state, int16 pcm
    [n, F]).  ``bins`` and ``resid`` are the group's device constants."""
    carry, phase = state
    chan = (pfb_channelize_fused if (x.shape[-1] // (K // 2)) % 2 == 0
            else pfb_channelize)
    st, z = chan(carry, x, K)
    zb = z[bins]                                   # [n, F]
    F_len = zb.shape[1]
    n = torch.arange(F_len, dtype=torch.float32, device=x.device)
    ramp = fused_mul_add(resid[:, None], n, phase[:, None])
    osc = cis((2.0 * math.pi) * torch.remainder(ramp, 1.0))
    new_phase = torch.remainder(fused_mul_add(resid, F_len, phase), 1.0)
    audio = (zb * osc).real * gain * 32768.0
    pcm = torch.clamp(audio, -32767.0, 32767.0).to(torch.int16)
    return (st, new_phase), pcm


class PfbChannelizer:
    """Alternative to ``Channelizer`` for uniform-rate VFO banks, on
    ``device``.

    Groups sub VFOs by output rate; each group gets one K = 2*fs/out_rate
    filterbank pass, then a batched residual mix + real-audio conversion
    per VFO.  Main-VFO IQ topics are not supported here (use the tree
    channelizer for those): the constructor asserts, as the JAX one does.
    The state per rate is the complex64 filterbank carry [L - M] and the
    residual-mix phases [n].  Each group's step is a graphed step
    (``utils/graphs.py``, the counterpart of the JAX backend's per-group
    jit): a CUDA-graph replay per block on a card, its state in static
    buffers; ``_state`` and ``_phase`` read copies."""

    def __init__(self, cfg, audio_center: float = 1000.0, gain: float = 10.0,
                 device="cuda"):
        from collections import defaultdict
        self.cfg = cfg
        self.fs = cfg.sample_rate
        self.audio_center = audio_center
        self.gain = gain
        self.device = resolve_device(device)
        assert not any(m.topic for m in cfg.mains), \
            "PFB backend serves sub-VFO audio only"
        self.groups = defaultdict(list)
        for i, s in enumerate(cfg.subs):
            self.groups[s.out_rate].append(i)
        self._steps = {}
        for out_rate, idxs in self.groups.items():
            K, _ = pfb_plan(self.fs, out_rate)
            bins = []
            resid = []
            for i in idxs:
                s = self.cfg.subs[i]
                delta = s.freq - cfg.center_frequency
                k = pfb_bin_for_freq(delta, self.fs, K)
                kc = k if k < K // 2 else k - K
                r = delta - kc * self.fs / K
                bins.append(k)
                # USB-audio convention: audio frequency = signal - rf, so
                # the bin output only needs the -r residual shift
                resid.append(-r / out_rate)
            step = functools.partial(
                _group_step, K=K,
                bins=torch.as_tensor(np.asarray(bins, np.int64),
                                     device=self.device),
                resid=torch.as_tensor(np.asarray(resid, np.float32),
                                      device=self.device),
                gain=self.gain)
            state = (pfb_init(K, device=self.device),
                     torch.zeros(len(idxs), dtype=torch.float32,
                                 device=self.device))
            self._steps[out_rate] = GraphedStep(
                step, state, f"PfbChannelizer group {out_rate}")

    @property
    def _state(self) -> dict:
        """A copy of each rate group's filterbank carry; assigning it
        writes the static buffers (checkpoint loads)."""
        return {r: s.state[0].clone() for r, s in self._steps.items()}

    @_state.setter
    def _state(self, carries: dict):
        for r, c in carries.items():
            step = self._steps[r]
            step.state = (c, step.state[1])

    @property
    def _phase(self) -> dict:
        """A copy of each rate group's residual-mix phases; assigning it
        writes the static buffers."""
        return {r: s.state[1].clone() for r, s in self._steps.items()}

    @_phase.setter
    def _phase(self, phases: dict):
        for r, p in phases.items():
            step = self._steps[r]
            step.state = (step.state[0], p)

    @property
    def captures(self) -> int:
        """CUDA graphs captured by the group steps so far."""
        return sum(s.captures for s in self._steps.values())

    def process(self, iq: np.ndarray) -> list:
        """iq [T] complex64 -> [(topic, out_rate, int16 audio payload), ...]"""
        out = []
        iq = np.asarray(iq, np.complex64)
        x = torch.from_numpy(np.ascontiguousarray(iq)).to(self.device)
        for out_rate, idxs in self.groups.items():
            pcm = self._steps[out_rate](x).cpu().numpy()
            for row, i in enumerate(idxs):
                out.append((self.cfg.subs[i].topic, out_rate,
                            pcm[row].astype("<i2").tobytes()))
        return out
