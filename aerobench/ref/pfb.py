"""Frozen plain copy of the WOLA filterbank of
``aero_tpu_torch/channelizer/pfb.py``, part of the benchmark's
reference: plain PyTorch, run eagerly, importing nothing of the port.
The port may change; this copy does not."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from aerobench.ref.design import low_pass_design


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
