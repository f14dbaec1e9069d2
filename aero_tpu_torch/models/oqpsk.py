"""Continuous OQPSK demodulator (10500 bps C-band P channel; 8400 bps
C-channel base) and modulator, torch.

Counterpart of ``aero_tpu/models/oqpsk.py``; read that module's docstring
for the design (the feedforward architecture of ``models/msk.py`` with an
RRC matched filter, strobes at rate fb alternating the Q and I arms, and a
straight soft mapping with no differential decode).

As ``msk_step``, ``oqpsk_step`` is written batched: every ``OqpskState``
field carries a leading [B] axis (same names and order as JAX's, so
``convert`` carries states across), samples are [B, block_len].  The
numerics that differ from the JAX CPU reference are those of
``models/msk.py`` (tone-grid GEMM order, the chirp cumsum, half-to-even
rounding on a .5 boundary) plus, at 8400, the 2049-tap matched filter by
FFT (``ops/fir.py:fir_apply_fft``), which agrees to float32 FFT error.

The strobe step fs/fb is fractional at 10500 (48000/10500 = 32/7): every
strobe is an interpolation, clamped to the index as JAX clamps it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.design import root_raised_cosine
from aero_tpu_torch.ops.fir import fir_apply, fir_apply_fft, fir_init
from aero_tpu_torch.ops.nco import cis, nco_init, nco_mix
from aero_tpu_torch.ops.stats import block_agc, msk_ebno
from aero_tpu_torch.utils.graphs import GraphedStep
from aero_tpu_torch.models.coarse_freq import (coarse_freq_init,
                                               coarse_freq_estimate)
from aero_tpu_torch.models.msk import (_chirp_cycles, _circdist,
                                       _doppler_fold, _interp,
                                       _segment_slope_track, _take,
                                       _timing_track, _tone_pair_sync)

_TWO_PI = 2.0 * math.pi


class OqpskState(NamedTuple):
    nco_phase: torch.Tensor      # mixer phase, cycles                  [B]
    freq: torch.Tensor           # current mix frequency, Hz            [B]
    slope: torch.Tensor          # CFO drift estimate, Hz/s             [B]
    coarse_y: torch.Tensor       # smoothed fold spectrum         [B, nfft]
    mf_state: torch.Tensor       # matched filter history [B, ntaps-1] c64
    agc_ema: torch.Tensor        # running mean |mf out|                [B]
    tail: torch.Tensor           # last tail_len filtered samples  [B, n] c64
    theta: torch.Tensor          # carrier phase at block start, rad    [B]
    grid: torch.Tensor           # position of the first (Q) strobe     [B]
    grid_rate: torch.Tensor      # grid drift, samples/block            [B]
    have_lock_refs: torch.Tensor  # bool: theta/grid carries valid      [B]
    mse: torch.Tensor            # constellation MSE EMA                [B]


class OqpskConfig(NamedTuple):
    fs: float
    fb: float
    block_len: int
    nfft: int
    lockingbw: float
    freq_center: float
    signal_threshold: float
    fine_span_hz: float
    fine_step_hz: float
    alpha: float
    ntaps: int
    tail_len: int
    track_span_hz: float
    track_segments: int

    @property
    def strobe_step(self) -> float:
        return self.fs / self.fb          # samples per strobe (fractional)

    @property
    def n_strobes(self) -> int:
        return int(round(self.block_len * self.fb / self.fs))


def make_config(fs: float, fb: float, block_len: int = 16000,
                lockingbw: float = 10500.0, freq_center: float = 8000.0,
                signal_threshold: float = 0.65, nfft: int = 8192,
                fine_span_hz: float | None = None,
                fine_step_hz: float = 0.25,
                track_span_hz: float = 240.0,
                track_segments: int = 8) -> OqpskConfig:
    n_strobes = block_len * fb / fs
    assert abs(n_strobes - round(n_strobes)) < 1e-9 \
        and round(n_strobes) % 2 == 0
    assert block_len >= nfft
    assert block_len % track_segments == 0
    if fine_span_hz is None:
        fine_span_hz = fs / nfft + 2.0
    alpha = 0.6 if fb == 8400 else 1.0
    step = fs / fb
    # the reference's short tail at 8400 (ceil(4*step)+2 < the 4.5*step
    # lookback, so the first Q strobe of a block clamps) is kept as JAX
    # has it: the port matches the reference as it stands
    tail_len = int(np.ceil(4 * step)) + 2
    # at 8400 a 2049-tap RRC fast-convolution prefilter replaces the
    # 55-tap matched filter (adjacent-channel rejection)
    ntaps = 2049 if fb == 8400 else 55
    return OqpskConfig(fs, fb, block_len, nfft, lockingbw, freq_center,
                       signal_threshold, fine_span_hz, fine_step_hz, alpha,
                       ntaps, tail_len, track_span_hz, track_segments)


def oqpsk_init(cfg: OqpskConfig, batch: int = 1, device="cpu") -> OqpskState:
    """Initial state for ``batch`` VFOs (every field has a leading [B])."""
    def full(v, dtype=torch.float32):
        return torch.full((batch,), v, dtype=dtype, device=device)
    return OqpskState(
        nco_phase=nco_init(0.0, device, (batch,)),
        freq=full(cfg.freq_center),
        slope=full(0.0),
        coarse_y=coarse_freq_init(cfg.nfft, (batch,), device=device),
        mf_state=fir_init(cfg.ntaps, (batch,), torch.complex64, device),
        agc_ema=full(0.0),
        tail=torch.zeros((batch, cfg.tail_len), dtype=torch.complex64,
                         device=device),
        theta=full(0.0),
        grid=full(0.0),
        grid_rate=full(0.0),
        have_lock_refs=full(False, torch.bool),
        mse=full(2.0),
    )


@functools.lru_cache(maxsize=None)
def _rrc_taps(alpha: float, ntaps: int, fs: float, fb: float, device):
    return torch.from_numpy(np.asarray(
        root_raised_cosine(alpha, ntaps, fs, fb / 2.0), np.float32)).to(device)


def _soft_bytes(v):
    # torch.round is half-to-even, as jnp.round
    return torch.clamp(torch.round(0.75 * v * 127.0 + 128.0), 0, 255)


def oqpsk_step(state: OqpskState, samples, cfg: OqpskConfig):
    """Process one block of real audio for B VFOs: samples [B, block_len].

    Returns (new_state, outputs dict of [B, ...] tensors).  Soft bits: two
    per symbol [Q (imag), I (real)], bytes 0..255 (128 = neutral)."""
    L = cfg.block_len
    step = cfg.strobe_step                 # Ts/2 in samples
    x = torch.as_tensor(samples, dtype=torch.float32)
    dev = x.device
    B = x.shape[0]

    fnorm = state.freq / cfg.fs
    chirp_cyc, chirp_end = _chirp_cycles(state.slope, cfg.fs, L)
    nco_phase, bb = nco_mix(state.nco_phase, x.to(torch.complex64), fnorm,
                            conj=True, extra_cycles=chirp_cyc)
    nco_phase = torch.remainder(nco_phase + chirp_end, 1.0)
    T_blk = L / float(cfg.fs)

    coarse_y, dfc = coarse_freq_estimate(
        state.coarse_y, bb, nfft=cfg.nfft, fb=cfg.fb, fs=cfg.fs,
        lockingbw=cfg.lockingbw)

    taps = _rrc_taps(cfg.alpha, cfg.ntaps, cfg.fs, cfg.fb, dev)
    if cfg.ntaps > 256:
        mf_state, y = fir_apply_fft(state.mf_state, bb, taps)
    else:
        mf_state, y = fir_apply(state.mf_state, bb, taps)

    agc_ema, gain = block_agc(state.agc_ema, torch.abs(y))
    y = y * gain[:, None]
    mag = torch.abs(y)
    y = torch.where(mag > 2.84,
                    y * (2.84 / torch.clamp(mag, min=1e-9)), y)

    fb_norm = cfg.fb / cfg.fs
    df, theta0, t0_sym, quality = _tone_pair_sync(
        y, fb_norm, cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)
    df_wide, slope_res, tq = _segment_slope_track(
        y, fb_norm, 2.0 * cfg.track_span_hz / cfg.fs, cfg.track_segments)

    # carrier phase: candidates theta0 + k pi/2, continuity with the carry
    k4 = torch.arange(4, dtype=torch.float32, device=dev)
    cand_th = theta0[:, None] + k4 * (math.pi / 2.0)
    dth = _circdist(cand_th, state.theta[:, None], _TWO_PI)
    th_cont = _take(cand_th, torch.argmin(dth, dim=-1))
    theta = torch.where(state.have_lock_refs, th_cont, theta0)

    # derotate; the tail context is rotated on float32 offsets -TAIL..-1
    TAIL = cfg.tail_len
    n = torch.arange(L, dtype=torch.float32, device=dev)
    rot = cis(-(theta[:, None] + 2.0 * math.pi * df[:, None] * n))
    yr = y * rot
    tail_rot = cis(-(theta[:, None] + 2.0 * math.pi * df[:, None]
                     * torch.arange(-TAIL, 0, dtype=torch.float32,
                                    device=dev)))
    ctx = torch.cat([state.tail * tail_rot, yr], dim=-1)
    tail = y[:, -TAIL:]

    n_pairs = cfg.n_strobes // 2
    m = torch.arange(n_pairs, dtype=torch.float32, device=dev)
    scale = (1.0 + state.grid_rate / L)[:, None]

    def pair_points(g):
        # Q strobes two pair-intervals in the past, I strobes half a
        # symbol later, spacing scaled by the tracked clock ratio (see the
        # JAX version); _interp clamps to [0, N-2] as JAX's interp
        pos_q = g[:, None] + (m - 2.0) * (2.0 * step) * scale
        pos_i = pos_q + step * scale
        q = _interp(ctx, pos_q + TAIL).imag
        i = _interp(ctx, pos_i + TAIL).real
        return i, q

    g_raw = torch.remainder(t0_sym * step, step)
    cand = (g_raw, g_raw + step)

    def eye_mse(g):
        i, q = pair_points(g)
        mean_mag = torch.clamp(torch.mean(torch.sqrt(i * i + q * q), dim=-1),
                               min=1e-6)
        s = (math.sqrt(2.0) / mean_mag)[:, None]
        tda = torch.abs(i * s) - 1.0
        tdb = torch.abs(q * s) - 1.0
        return torch.mean(tda * tda + tdb * tdb, dim=-1)

    # the two arm pairings a strobe apart, picked by eye quality
    grid_acq = torch.where(eye_mse(cand[0]) <= eye_mse(cand[1]),
                           cand[0], cand[1])
    grid_acq = grid_acq - torch.round(
        (grid_acq - state.grid) / (2.0 * step)) * (2.0 * step)

    tracking = state.have_lock_refs & (state.mse < cfg.signal_threshold)
    grid, grid_rate, slip = _timing_track(
        state.grid, state.grid_rate, g_raw, step, tracking, L, grid_acq)

    pt_i, pt_q = pair_points(grid)

    # soft bits: imag (Q) first then real (I)
    soft = torch.stack([_soft_bytes(pt_q), _soft_bytes(pt_i)],
                       dim=-1).reshape(B, -1).to(torch.uint8)

    # the EMA restarts from the fresh block after a retune
    blk_mse = eye_mse(grid)
    mse = torch.where(state.have_lock_refs,
                      0.7 * state.mse + 0.3 * blk_mse, blk_mse)
    locked = mse < cfg.signal_threshold

    _m = torch.mean(mag, dim=-1)
    _v = torch.mean(mag * mag, dim=-1) - _m * _m
    ebno_db = msk_ebno(_m, _v)

    retune_threshold = 1.6 * (cfg.fs / cfg.nfft)
    stuck = torch.abs(dfc) > 4.0 * cfg.fine_span_hz
    retune = (torch.abs(dfc) > retune_threshold) \
        & (torch.logical_not(locked) | stuck)
    freq = torch.where(retune, state.freq + dfc, state.freq)
    coarse_y = torch.where(retune[:, None], torch.full_like(coarse_y, 20.0),
                           coarse_y)
    # the C-band clamps are 2x the L-band ones (2.4x the Doppler rates)
    freq, slope, wide_jump, tq_ok = _doppler_fold(
        state.slope, freq, retune, locked, df, df_wide, slope_res, tq,
        cfg.fs, T_blk, cfg.fine_span_hz, clamp_hzps=160.0, slope_max=800.0)
    theta_next = torch.remainder(theta + 2.0 * math.pi * df * L, _TWO_PI)
    have_refs = torch.logical_not(retune | wide_jump)
    agc_ema = torch.where(retune, torch.zeros_like(agc_ema), agc_ema)

    new_state = OqpskState(nco_phase, freq, slope, coarse_y, mf_state,
                           agc_ema, tail, theta_next, grid, grid_rate,
                           have_refs, mse)
    out = {
        "soft_bits": soft,
        "mse": mse,
        "freq": freq,
        "slope": slope,
        "coarse_offset": dfc,
        "fine_offset": df * cfg.fs,
        "wide_offset": df_wide * cfg.fs,
        "track_quality": tq,
        "tone_quality": quality,
        "signal": locked,
        "ebno": ebno_db,
        "grid": grid,
        "clock_ppm": grid_rate / L * 1e6,
        "slip": slip,
        "scatter": torch.stack([pt_i, pt_q], dim=-1),
    }
    return new_state, out


class OqpskDemodulator:
    """Host wrapper: one VFO, streaming over blocks, on ``device``.

    Each block is one graphed ``oqpsk_step`` on [1, block_len]
    (``utils/graphs.py``; ``cfg`` static): a CUDA-graph replay on a card,
    captured at the first block, the state in the step's static buffers.
    ``state`` reads a copy; assigning it writes the buffers in place (a
    retune captures nothing new)."""

    def __init__(self, fs: float, fb: float, device="cuda", **kw):
        self.cfg = make_config(fs, fb, **kw)
        self.device = resolve_device(device)
        self._step = GraphedStep(oqpsk_step,
                                 oqpsk_init(self.cfg, 1, self.device),
                                 "OqpskDemodulator oqpsk_step")

    @property
    def state(self):
        """A copy of the demodulator's state ([1] VFO axis)."""
        return self._step.snapshot()

    @state.setter
    def state(self, tree):
        self._step.state = tree

    @property
    def steps(self) -> list:
        """The graphed step (one, as the burst demodulators list theirs)."""
        return [self._step]

    def process(self, samples: np.ndarray):
        """Whole blocks of ``samples``; one dict of numpy outputs (the
        VFO axis dropped) per block."""
        outs = []
        L = self.cfg.block_len
        n = (len(samples) // L) * L
        for i in range(0, n, L):
            blk = torch.from_numpy(np.ascontiguousarray(
                samples[i:i + L], np.float32))[None]
            out = self._step(blk, self.cfg)
            outs.append({k: v[0].cpu().numpy() for k, v in out.items()})
        return outs

    def spectrum(self, nbins: int = 256):
        """Smoothed fold-spectrum snapshot: (freqs_hz, dB)."""
        from aero_tpu_torch.models.coarse_freq import spectrum_display
        return spectrum_display(self._step.state.coarse_y[0].cpu().numpy(),
                                self.cfg.fs, nbins)


# ---------------------------------------------------------------------------
# Modulator (numpy; for synthetic test vectors)
# ---------------------------------------------------------------------------

def oqpsk_modulate(bits, fs: float, fb: float, freq: float = 8000.0,
                   amplitude: float = 0.25,
                   alpha: float | None = None) -> np.ndarray:
    """OQPSK-modulate a bit stream to real audio at ``fs``.

    Stream layout matches the demodulator: bit 2m -> Q symbol m (imag
    arm), bit 2m+1 -> I symbol m (real arm, half a symbol later).
    Synthesis runs on an oversampled integer grid (16 samples/bit) and is
    polyphase-resampled to ``fs``.
    """
    from scipy.signal import resample_poly
    from fractions import Fraction

    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) % 2:
        bits = np.append(bits, 0)
    if alpha is None:
        alpha = 0.6 if fb == 8400 else 1.0
    q = 1.0 - 2.0 * (bits[0::2] < 1)      # bit 1 -> +1
    i = 1.0 - 2.0 * (bits[1::2] < 1)

    os_per_bit = 16
    fs_hi = fb * os_per_bit
    sym_step = 2 * os_per_bit             # samples per symbol on the hi grid
    n_hi = len(q) * sym_step + 8 * sym_step
    qi_train = np.zeros(n_hi)
    ii_train = np.zeros(n_hi)
    off = 2 * sym_step
    qi_train[off + np.arange(len(q)) * sym_step] = q
    ii_train[off + os_per_bit + np.arange(len(i)) * sym_step] = i

    g = root_raised_cosine(alpha, 8 * sym_step + 1, fs_hi, fb / 2.0)
    xi = np.convolve(ii_train, g, mode="same")
    xq = np.convolve(qi_train, g, mode="same")
    x_hi = xi + 1j * xq

    frac = Fraction(int(fs), int(fs_hi)).limit_denominator(10000)
    x = resample_poly(x_hi, frac.numerator, frac.denominator)
    n = np.arange(len(x))
    s = amplitude * (x * np.exp(2j * np.pi * freq / fs * n)).real
    s /= max(1e-9, np.max(np.abs(s))) / amplitude
    return s.astype(np.float32)
