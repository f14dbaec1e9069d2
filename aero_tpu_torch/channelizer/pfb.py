"""Polyphase (WOLA) filterbank channelizer (torch).

Counterpart of ``aero_tpu/channelizer/pfb.py``: ``pfb_prototype`` (the same
numpy design), ``pfb_init``, ``pfb_channelize``, ``pfb_channelize_fused``,
``pfb_bin_for_freq``, ``pfb_extract_vfo`` and the ``PfbChannelizer``
backend of the classic station.  Channel k of the output is the input mixed down
by k*fs/K, filtered by the prototype and decimated by the hop M = K/2:

    z[k, m] = sum_j h[j] x[mM - j] exp(-2j pi k (mM - j) / K)

The state is the last L-M input samples (complex64).  In the fused form
the fold is a depthwise convolution, ``F.conv1d(groups=K)`` over the real
and imaginary rows (cuDNN on the card, held at full float32).
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


@functools.lru_cache(maxsize=None)
def _tables(K: int, P: int, F_hops: int, device):
    """Per-device constants: reversed prototype [P*K], depthwise fold
    weights [K, 1, P], and the output twiddle [F, K].

    The twiddle keeps the JAX arithmetic (angle = fl(-2pi * k*r) / K in
    float32, with r = ((m+1)*M) % K): an exactly reduced angle would
    differ from the reference by up to ~3e-5 rad at k*r ~ 16000."""
    M = K // 2
    h = pfb_prototype(K, P)
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
             device="cpu"):
    L = taps_per_branch * K
    M = K // 2
    return torch.zeros(batch_shape + (L - M,), dtype=torch.complex64,
                       device=device)


def pfb_channelize(state, x, K: int, taps_per_branch: int = 8):
    """x: [T] complex wideband (T % (K//2) == 0).

    Returns (new_state, z [K, T//(K//2)]) — K channels, 2x oversampled,
    channel k centered at k*fs/K (k > K/2 wraps to negative)."""
    M = K // 2
    P = taps_per_branch
    L = P * K
    T = x.shape[-1]
    F_hops = T // M
    hrev, _, tw = _tables(K, P, F_hops, x.device)

    xp = torch.cat([state, x])                        # [T + L - M]
    frames = xp.unfold(0, L, M)[:F_hops]              # [F, L], frame m at mM
    folded = (frames * hrev).reshape(F_hops, P, K).sum(dim=1)
    z = torch.fft.fft(folded, dim=-1) * tw
    return xp[-(L - M):], z.T.contiguous()


def pfb_channelize_fused(state, x, K: int, taps_per_branch: int = 8):
    """Equal to ``pfb_channelize`` (M = K//2, an even number of hops):
    frames at even/odd hops align to K-sample rows of the stream, so the
    fold is a P-tap depthwise convolution along the row axis and each
    wideband sample is read once per parity instead of P times."""
    M = K // 2
    P = taps_per_branch
    L = P * K
    T = x.shape[-1]
    F_hops = T // M
    assert F_hops % 2 == 0, "need an even number of hops per block"
    _, w, tw = _tables(K, P, F_hops, x.device)

    xp = torch.cat([state, x])                        # [T + L - M]
    Q = F_hops // 2
    rows_e = xp[: (Q + P - 1) * K].reshape(Q + P - 1, K)
    rows_o = xp[M: M + (Q + P - 1) * K].reshape(Q + P - 1, K)
    # out[q, k] = sum_c hrev[c*K + k] * rows[q + c, k]: one grouped conv
    # over the four real rows (even/odd parity x real/imag)
    rows = torch.stack([rows_e.real, rows_e.imag, rows_o.real, rows_o.imag])
    y = F.conv1d(rows.transpose(1, 2), w, groups=K)   # [4, K, Q]
    fe = torch.complex(y[0], y[1]).T                  # [Q, K]
    fo = torch.complex(y[2], y[3]).T
    folded = torch.stack([fe, fo], dim=1).reshape(F_hops, K)
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


class PfbChannelizer:
    """Alternative to ``Channelizer`` for uniform-rate VFO banks, on
    ``device``.

    Groups sub VFOs by output rate; each group gets one K = 2*fs/out_rate
    filterbank pass, then a batched residual mix + real-audio conversion
    per VFO.  Main-VFO IQ topics are not supported here (use the tree
    channelizer for those): the constructor asserts, as the JAX one does.
    The state per rate is the complex64 filterbank carry [L - M] and the
    residual-mix phases [n]."""

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
        self._state = {}
        self._phase = {}
        self._params = {}
        for out_rate, idxs in self.groups.items():
            K = int(round(2 * self.fs / out_rate))
            assert abs(2 * self.fs / out_rate - K) < 1e-9, \
                f"out_rate {out_rate} incompatible with fs {self.fs}"
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
            self._params[out_rate] = (
                K, torch.as_tensor(np.asarray(bins, np.int64),
                                   device=self.device),
                torch.as_tensor(np.asarray(resid, np.float32),
                                device=self.device))
            self._state[out_rate] = pfb_init(K, device=self.device)
            self._phase[out_rate] = torch.zeros(len(idxs),
                                                dtype=torch.float32,
                                                device=self.device)

    def _group_step(self, out_rate, x):
        """One rate group: (new carry, new phases, int16 pcm [n, F])."""
        K, bins, resid = self._params[out_rate]
        chan = (pfb_channelize_fused if (x.shape[-1] // (K // 2)) % 2 == 0
                else pfb_channelize)
        st, z = chan(self._state[out_rate], x, K)
        zb = z[bins]                                   # [n, F]
        F_len = zb.shape[1]
        phase = self._phase[out_rate]
        n = torch.arange(F_len, dtype=torch.float32, device=x.device)
        ramp = fused_mul_add(resid[:, None], n, phase[:, None])
        osc = cis((2.0 * math.pi) * torch.remainder(ramp, 1.0))
        new_phase = torch.remainder(fused_mul_add(resid, F_len, phase), 1.0)
        audio = (zb * osc).real * self.gain * 32768.0
        pcm = torch.clamp(audio, -32767.0, 32767.0).to(torch.int16)
        return st, new_phase, pcm

    def process(self, iq: np.ndarray) -> list:
        """iq [T] complex64 -> [(topic, out_rate, int16 audio payload), ...]"""
        out = []
        iq = np.asarray(iq, np.complex64)
        x = torch.from_numpy(np.ascontiguousarray(iq)).to(self.device)
        for out_rate, idxs in self.groups.items():
            self._state[out_rate], self._phase[out_rate], pcm = \
                self._group_step(out_rate, x)
            pcm = pcm.cpu().numpy()
            for row, i in enumerate(idxs):
                out.append((self.cfg.subs[i].topic, out_rate,
                            pcm[row].astype("<i2").tobytes()))
        return out
