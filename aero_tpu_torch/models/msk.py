"""Continuous MSK demodulator (600/1200 bps Aero P channel), torch.

Counterpart of ``aero_tpu/models/msk.py``; read that module's docstring for
the design (a fully feedforward block demodulator: mix, coarse CFO, matched
filter, AGC, joint fine-CFO / phase / timing from the squared signal,
strobe interpolation, differential soft decode).

Where JAX vmaps ``msk_step`` over a VFO axis, this step is written batched:
every state field carries a leading [B] axis, samples are [B, L], and the
per-VFO scalar logic becomes ``torch.where`` on [B] tensors.  ``MskState``
keeps JAX's field names and order, so ``convert`` carries states across.

Numerics that differ from the JAX CPU reference, and how:

- the tone-grid DFTs (``_tone_pair_sync``, ``_segment_slope_track``) are
  complex GEMMs in another summation order; their argmax can flip on a
  near-tie, so the parity tests compare the step teacher-forced;
- ``_chirp_cycles`` uses a float32 cumsum whose order differs from XLA's;
- the differential decode rounds half-to-even like ``jnp.round``; a soft
  byte may still differ by one where the pre-round value sits on a .5
  boundary within float32 error.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.design import msk_matched_filter
from aero_tpu_torch.ops.fir import fir_init, fir_apply
from aero_tpu_torch.ops.nco import cis, nco_init, nco_mix
from aero_tpu_torch.ops.stats import block_agc, msk_ebno
from aero_tpu_torch.utils.graphs import GraphedStep
from aero_tpu_torch.models.coarse_freq import (coarse_freq_init,
                                               coarse_freq_estimate)

_TWO_PI = 2.0 * math.pi


class MskState(NamedTuple):
    nco_phase: torch.Tensor      # mixer phase, cycles                  [B]
    freq: torch.Tensor           # current mix frequency, Hz            [B]
    slope: torch.Tensor          # CFO drift estimate, Hz/s             [B]
    coarse_y: torch.Tensor       # smoothed fold spectrum         [B, nfft]
    mf_state: torch.Tensor       # matched filter history [B, 2*sps-1] c64
    agc_ema: torch.Tensor        # running mean |mf out|                [B]
    tail: torch.Tensor           # last 4*sps filtered samples [B, 4sps] c64
    theta: torch.Tensor          # carrier phase at block start, rad    [B]
    grid: torch.Tensor           # strobe-grid phase, samples mod 2*sps [B]
    grid_rate: torch.Tensor      # grid drift, samples/block            [B]
    have_lock_refs: torch.Tensor  # bool: theta/grid carries valid      [B]
    diff_im: torch.Tensor        # differential decoder memory, imag   [B]
    diff_re: torch.Tensor        # differential decoder memory, real   [B]
    mse: torch.Tensor            # constellation MSE EMA                [B]


class MskConfig(NamedTuple):
    fs: float
    fb: float
    sps: int
    block_len: int
    nfft: int
    lockingbw: float
    freq_center: float
    signal_threshold: float
    fine_span_hz: float
    fine_step_hz: float
    track_span_hz: float
    track_segments: int


def make_config(fs: float, fb: float, block_len: int = 16000,
                lockingbw: float = 900.0, freq_center: float = 1000.0,
                signal_threshold: float = 0.5, nfft: int = 8192,
                fine_span_hz: float | None = None,
                fine_step_hz: float = 0.25,
                track_span_hz: float = 200.0,
                track_segments: int = 8) -> MskConfig:
    sps = int(fs / fb)
    assert block_len % (2 * sps) == 0
    assert block_len >= nfft
    assert block_len % track_segments == 0
    if fine_span_hz is None:
        fine_span_hz = fs / nfft + 2.0
    return MskConfig(fs, fb, sps, block_len, nfft, lockingbw, freq_center,
                     signal_threshold, fine_span_hz, fine_step_hz,
                     track_span_hz, track_segments)


def msk_init(cfg: MskConfig, batch: int = 1, device="cpu") -> MskState:
    """Initial state for ``batch`` VFOs (every field has a leading [B])."""
    def full(v, dtype=torch.float32):
        return torch.full((batch,), v, dtype=dtype, device=device)
    return MskState(
        nco_phase=nco_init(0.0, device, (batch,)),
        freq=full(cfg.freq_center),
        slope=full(0.0),
        coarse_y=coarse_freq_init(cfg.nfft, (batch,), device=device),
        mf_state=fir_init(2 * cfg.sps, (batch,), torch.complex64, device),
        agc_ema=full(0.0),
        tail=torch.zeros((batch, 4 * cfg.sps), dtype=torch.complex64,
                         device=device),
        theta=full(0.0),
        grid=full(0.0),
        grid_rate=full(0.0),
        have_lock_refs=full(False, torch.bool),
        diff_im=full(-1.0),
        diff_re=full(-1.0),
        mse=full(2.0),
    )


@functools.lru_cache(maxsize=None)
def _tone_grid(T: int, fb_norm: float, span_cyc: float, step_cyc: float):
    """Static candidate grid and its DFT matrix (numpy, cached)."""
    n = np.arange(T, dtype=np.float64)
    nu = np.arange(-span_cyc, span_cyc + step_cyc / 2, step_cyc,
                   dtype=np.float64)
    freqs = np.concatenate([nu + fb_norm / 2.0, nu - fb_norm / 2.0])
    tw = np.exp(-2j * np.pi * (freqs[:, None] * n[None, :] % 1.0))
    return nu.astype(np.float32), tw.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _track_grid(T: int, fb_norm: float, span_cyc: float):
    """Wide, coarse tone grid for the per-segment CFO-slope tracker
    (numpy, cached; step = half a segment DFT bin)."""
    step = 0.5 / T
    n = np.arange(T, dtype=np.float64)
    nu = np.arange(-span_cyc, span_cyc + step / 2, step, dtype=np.float64)
    freqs = np.concatenate([nu + fb_norm / 2.0, nu - fb_norm / 2.0])
    tw = np.exp(-2j * np.pi * (freqs[:, None] * n[None, :] % 1.0))
    return nu.astype(np.float32), tw.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _grid_on(grid_fn, args: tuple, device):
    """A grid's (nu, tw^T) as tensors on ``device``, built once each."""
    nu, tw = grid_fn(*args)
    return (torch.from_numpy(nu).to(device),
            torch.from_numpy(np.ascontiguousarray(tw.T)).to(device))


@functools.lru_cache(maxsize=None)
def _mf_taps(sps: int, device):
    return torch.from_numpy(
        np.asarray(msk_matched_filter(sps), np.float32)).to(device)


def _dft_at(x, f):
    """DFT of x [B, n] at one frequency per row f [B] (cycles/sample)."""
    nn = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    twl = cis(-_TWO_PI * torch.remainder(f[:, None] * nn, 1.0))
    return torch.sum(x * twl, dim=-1)


def _tone_pair_sync(y, fb_norm, span_cyc, step_cyc):
    """Estimate (df_norm, theta0, t0_bits, quality) from the squared
    signal; y: [B, T] complex matched-filter output."""
    T = y.shape[-1]
    s2 = y * y
    # the static [T, 2C] DFT matrix is built once per config and device.
    # This GEMM ([B, T] x [T, 2C], e.g. [50, 16000] x [16000, 80]) sums in
    # another order than XLA's einsum; the argmax below can flip on a
    # near-tie between the two backends (compare teacher-forced)
    nu, twT = _grid_on(_tone_grid, (T, float(fb_norm), float(span_cyc),
                                    float(step_cyc)), y.device)
    coeffs = s2 @ twT
    C = nu.shape[0]
    c_hi, c_lo = coeffs[:, :C], coeffs[:, C:]
    score = torch.abs(c_hi) + torch.abs(c_lo)
    best = torch.argmax(score, dim=-1)
    nu_hat = nu[best]

    # refine nu by the phase slope between block halves at the winning bin
    half = T // 2
    f_ref = nu_hat + fb_norm / 2.0
    c1 = _dft_at(s2[:, :half], f_ref)
    c2 = _dft_at(s2[:, half:], f_ref) * cis(
        -_TWO_PI * torch.remainder(f_ref * half, 1.0))
    dnu = torch.angle(c2 * torch.conj(c1)) / (_TWO_PI * half)
    nu_hat = nu_hat + dnu
    a_p = _dft_at(s2, nu_hat + fb_norm / 2.0)
    a_m = _dft_at(s2, nu_hat - fb_norm / 2.0)

    df = nu_hat / 2.0
    theta0 = torch.angle(a_p * a_m) / 4.0
    t0 = -torch.angle(a_p * torch.conj(a_m)) / _TWO_PI
    quality = (torch.abs(a_p) + torch.abs(a_m)) / float(T)
    return df, theta0, t0, quality


def _take(v, idx):
    """v [..., C] at idx [...] (per-row gather)."""
    return torch.gather(v, -1, idx[..., None])[..., 0]


def _segment_slope_track(y, fb_norm, span_cyc, S):
    """Residual CFO ramp from per-segment tones of the squared signal.

    Returns (df_wide, slope_res, quality), each [B]: residual average CFO
    at block centre [cycles/sample], residual slope [cycles/sample^2],
    and the gated segment tone quality (see the JAX docstring)."""
    B = y.shape[0]
    T = y.shape[-1] // S
    s2 = (y * y).reshape(B, S, T)
    # [B*S, T] x [T, 2C]: the second tone-grid GEMM (e.g. [400, 2000] x
    # [2000, 268]); argmax near-ties as in _tone_pair_sync
    nu, twT = _grid_on(_track_grid, (T, float(fb_norm), float(span_cyc)),
                       y.device)
    coeffs = s2 @ twT
    C = nu.shape[0]
    score = torch.abs(coeffs[..., :C]) + torch.abs(coeffs[..., C:])  # [B,S,C]
    best = torch.argmax(score, dim=-1)                              # [B,S]
    step = nu[1] - nu[0]
    bl = torch.clamp(best - 1, 0, C - 1)
    br = torch.clamp(best + 1, 0, C - 1)
    s0 = _take(score, best)
    sl = _take(score, bl)
    sr = _take(score, br)
    denom = sl - 2.0 * s0 + sr
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (sl - sr) / denom,
                       torch.zeros_like(denom))
    nu_s = nu[best] + torch.clamp(frac, -0.5, 0.5) * step
    w = s0
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    x = (torch.arange(S, dtype=torch.float32, device=y.device) + 0.5) * T
    xm = torch.sum(w * x, dim=-1, keepdim=True)
    ym = torch.sum(w * nu_s, dim=-1, keepdim=True)
    sxx = torch.sum(w * (x - xm) ** 2, dim=-1)
    sxy = torch.sum(w * (x - xm) * (nu_s - ym), dim=-1)
    b = sxy / torch.clamp(sxx, min=1e-9)
    a_mid = ym[..., 0] + b * (S * T / 2.0 - xm[..., 0])
    peak = s0
    par = peak / torch.clamp(torch.mean(score, dim=-1), min=1e-9)
    quality = torch.sum(w * par, dim=-1)
    fitted = ym + b[..., None] * (x - xm)
    resid = torch.sqrt(torch.sum(w * (nu_s - fitted) ** 2, dim=-1))
    quality = torch.where(resid < 4.0 * (0.5 / T), quality,
                          torch.zeros_like(quality))
    return a_mid / 2.0, b / 2.0, quality


def _chirp_cycles(slope, fs, L):
    """Per-sample chirp phase (cycles) [B, L] for the carried CFO slope
    [B], plus the end-of-block phase [B] to fold into the NCO carry.

    Keeps the JAX form: 0.5*s*n^2 by a float32 cumsum (n^2 overflows the
    float32 mantissa at n=16000), a float32 ``arange``, and the
    ``float()`` guards (fs may arrive as an int).  torch's cumsum sums in
    another order than XLA's, so the chirp agrees to float32 error, not
    bit for bit; the phase tolerance in the parity tests covers it."""
    slope_cps2 = slope / (float(fs) * float(fs))
    n_all = torch.arange(L, dtype=torch.float32, device=slope.device)
    inc = slope_cps2[:, None] * (n_all + 0.5)
    chirp_cyc = torch.cumsum(inc, dim=-1) - inc
    chirp_end = (0.5 * L) * (slope_cps2 * L)
    return chirp_cyc, chirp_end


def _doppler_fold(prev_slope, freq, retune, locked, df, df_wide, slope_res,
                  tq, fs, T_blk, fine_span_hz, clamp_hzps, slope_max):
    """Doppler fold-in + block-rate slope tracker (see the JAX docstring).

    Returns (freq, slope, wide_jump, tq_ok)."""
    zero = torch.zeros_like(freq)
    tq_ok = tq > 3.5
    df_wide_hz = df_wide * fs
    slope_res_hz = slope_res * (float(fs) * float(fs))
    wide_jump = (torch.abs(df_wide_hz) > fine_span_hz) \
        & tq_ok & torch.logical_not(retune)
    end_corr = torch.where(
        tq_ok,
        0.5 * torch.clamp(slope_res_hz, -clamp_hzps, clamp_hzps) * T_blk,
        zero)
    freq = freq + prev_slope * T_blk \
        + torch.where(retune, zero,
                      torch.where(wide_jump, df_wide_hz, df * fs) + end_corr)
    slope = prev_slope + torch.where(
        tq_ok, torch.clamp(0.7 * slope_res_hz, -clamp_hzps, clamp_hzps),
        zero)
    slope = torch.where(tq_ok | locked, slope, 0.9 * slope)
    slope = torch.clamp(slope, -slope_max, slope_max)
    return freq, slope, wide_jump, tq_ok


def _timing_track(prev_grid, prev_rate, g_raw, unit, tracking, L,
                  grid_acq):
    """Second-order timing loop (alpha-beta on grid + drift rate).

    Returns (grid, grid_rate, slip); slip is int32 [B]."""
    pred = prev_grid + prev_rate
    delta = torch.remainder(g_raw - pred + unit / 2.0, unit) - unit / 2.0
    grid_track = pred + 0.5 * delta
    rate_max = 300e-6 * L
    grid_rate = torch.where(tracking, prev_rate + 0.25 * delta,
                            0.95 * prev_rate)
    grid_rate = torch.clamp(grid_rate, -rate_max, rate_max)
    grid = torch.where(tracking, grid_track, grid_acq)
    slip = ((tracking & (grid < -0.5 * unit)).to(torch.int32)
            - (tracking & (grid >= 2.5 * unit)).to(torch.int32))
    grid = torch.where(grid < -0.5 * unit, grid + 2.0 * unit,
                       torch.where(grid >= 2.5 * unit, grid - 2.0 * unit,
                                   grid))
    return grid, grid_rate, slip


def _circdist(a, b, m):
    return torch.abs(torch.remainder(a - b + m / 2, m) - m / 2)


def _interp(sig, p):
    """Linear interpolation of sig [B, N] at positions p [B, M].

    The clamp at N-2 and the floor index match the JAX version to the
    index (``floor`` -> ``.long()``, gathers on the same rows)."""
    p = torch.clamp(p, 0.0, sig.shape[-1] - 2.0)
    i0 = torch.floor(p).long()
    w = p - i0.to(torch.float32)
    return (torch.gather(sig, -1, i0) * (1.0 - w)
            + torch.gather(sig, -1, i0 + 1) * w)


def _diffdecode(seq, carry):
    """Differential decode along the strobe axis: seq [B, M], carry [B]."""
    prev = torch.cat([carry[:, None], seq[:, :-1]], dim=-1)
    both_neg = (seq < 0) & (prev < 0)
    both_pos = (seq > 0) & (prev > 0)
    out = torch.where(both_neg, prev,
                      torch.where(both_pos, -prev, torch.abs(prev)))
    return out, seq[:, -1]


def _soft_bytes(v):
    # torch.round is half-to-even, as jnp.round
    return torch.clamp(torch.round(v * 127.0 + 128.0), 0, 255)


def msk_step(state: MskState, samples, cfg: MskConfig):
    """Process one block of real audio for B VFOs: samples [B, block_len].

    Returns (new_state, outputs dict of [B, ...] tensors).  Soft bits: two
    per strobe [imag_bit, real_bit], bytes 0..255 (128 = neutral)."""
    sps = cfg.sps
    L = cfg.block_len
    x = torch.as_tensor(samples, dtype=torch.float32)
    dev = x.device

    # 1. mix to baseband, chirp-derotate by the carried CFO slope
    fnorm = state.freq / cfg.fs
    chirp_cyc, chirp_end = _chirp_cycles(state.slope, cfg.fs, L)
    nco_phase, bb = nco_mix(state.nco_phase, x.to(torch.complex64), fnorm,
                            conj=True, extra_cycles=chirp_cyc)
    nco_phase = torch.remainder(nco_phase + chirp_end, 1.0)
    T_blk = L / float(cfg.fs)

    # 2. coarse CFO estimate (drives retunes while unlocked)
    coarse_y, dfc = coarse_freq_estimate(
        state.coarse_y, bb, nfft=cfg.nfft, fb=cfg.fb, fs=cfg.fs,
        lockingbw=cfg.lockingbw)

    # 3. matched filter
    mf_state, y = fir_apply(state.mf_state, bb, _mf_taps(sps, dev))

    # 4. AGC + clip
    agc_ema, gain = block_agc(state.agc_ema, torch.abs(y))
    y = y * gain[:, None]
    mag = torch.abs(y)
    y = torch.where(mag > 2.84,
                    y * (2.84 / torch.clamp(mag, min=1e-9)), y)

    # 5. joint feedforward sync from the squared signal
    fb_norm = cfg.fb / cfg.fs
    df, theta0, t0_bits, quality = _tone_pair_sync(
        y, fb_norm, cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)
    # 5b. residual-ramp measurement (Doppler tracking)
    df_wide, slope_res, tq = _segment_slope_track(
        y, fb_norm, 2.0 * cfg.track_span_hz / cfg.fs, cfg.track_segments)

    # carrier phase: candidates theta0 + k pi/2, continuity with carry
    k = torch.arange(4, dtype=torch.float32, device=dev)
    cand_th = theta0[:, None] + k * (math.pi / 2.0)
    dth = _circdist(cand_th, state.theta[:, None], _TWO_PI)
    th_cont = _take(cand_th, torch.argmin(dth, dim=-1))
    theta = torch.where(state.have_lock_refs, th_cont, theta0)

    # 6. derotate the whole block
    TAIL = 4 * sps
    n = torch.arange(L, dtype=torch.float32, device=dev)
    rot = cis(-(theta[:, None] + 2.0 * math.pi * df[:, None] * n))
    yr = y * rot
    tail_rot = cis(-(theta[:, None] + 2.0 * math.pi * df[:, None]
                     * torch.arange(-TAIL, 0, dtype=torch.float32,
                                    device=dev)))
    ctx = torch.cat([state.tail * tail_rot, yr], dim=-1)
    tail = y[:, -TAIL:]

    n_strobes = L // (2 * sps)
    m = torch.arange(n_strobes, dtype=torch.float32, device=dev)
    stretch = (1.0 + state.grid_rate / L)[:, None]

    def strobes(g):
        # one pair-interval in the past (m-1), scaled by the tracked clock
        # ratio; see the JAX version for why
        pos = g[:, None] + (m - 1.0) * (2.0 * sps) * stretch
        return _interp(ctx, pos + TAIL), _interp(ctx, pos + TAIL - sps)

    g_raw = torch.remainder(t0_bits * sps, sps)
    cand = (g_raw, g_raw + sps)

    def eye_mse(g):
        pc, pd = strobes(g)
        tda = torch.abs(pc.real * 0.75) - 1.0
        tdb = torch.abs(pd.imag * 0.75) - 1.0
        return torch.mean(tda * tda + tdb * tdb, dim=-1)

    grid_acq = torch.where(eye_mse(cand[0]) <= eye_mse(cand[1]),
                           cand[0], cand[1])
    grid_acq = grid_acq - torch.round(
        (grid_acq - state.grid) / (2.0 * sps)) * (2.0 * sps)

    tracking = state.have_lock_refs & (state.mse < cfg.signal_threshold)
    grid, grid_rate, slip = _timing_track(
        state.grid, state.grid_rate, g_raw, float(sps), tracking, L,
        grid_acq)

    pts_cur, pts_del = strobes(grid)
    pt_re = pts_cur.real
    pt_im = pts_del.imag

    # 7. vectorized differential soft decode (both arms), real arm negated
    scatter = torch.stack([pt_re, pt_im], dim=-1)
    ob_im, diff_im = _diffdecode(pt_im, state.diff_im)
    ob_re, diff_re = _diffdecode(pt_re, state.diff_re)
    ob_re = -ob_re
    soft = torch.stack([_soft_bytes(ob_im), _soft_bytes(ob_re)],
                       dim=-1).reshape(x.shape[0], -1).to(torch.uint8)

    # constellation MSE as a block mean + EMA carry
    tda = torch.abs(pt_re * 0.75) - 1.0
    tdb = torch.abs(pt_im * 0.75) - 1.0
    blk_mse = torch.mean(tda * tda + tdb * tdb, dim=-1)
    mse = torch.where(state.have_lock_refs,
                      0.7 * state.mse + 0.3 * blk_mse, blk_mse)
    locked = mse < cfg.signal_threshold

    # Eb/N0 estimate from the matched-filter envelope
    _m = torch.mean(mag, dim=-1)
    _v = torch.mean(mag * mag, dim=-1) - _m * _m
    ebno_db = msk_ebno(_m, _v)

    # AFC: while unlocked (or stuck beyond the fine span), retune by the
    # coarse estimate and flood the smoothed spectrum
    retune_threshold = 1.6 * (cfg.fs / cfg.nfft)
    stuck = torch.abs(dfc) > 4.0 * cfg.fine_span_hz
    retune = (torch.abs(dfc) > retune_threshold) \
        & (torch.logical_not(locked) | stuck)
    freq = torch.where(retune, state.freq + dfc, state.freq)
    coarse_y = torch.where(retune[:, None], torch.full_like(coarse_y, 20.0),
                           coarse_y)

    # fine-CFO fold-in and slope tracker
    freq, slope, wide_jump, tq_ok = _doppler_fold(
        state.slope, freq, retune, locked, df, df_wide, slope_res, tq,
        cfg.fs, T_blk, cfg.fine_span_hz, clamp_hzps=80.0, slope_max=400.0)
    theta_next = torch.remainder(theta + 2.0 * math.pi * df * L, _TWO_PI)
    have_refs = torch.logical_not(retune | wide_jump)
    agc_ema = torch.where(retune, torch.zeros_like(agc_ema), agc_ema)

    new_state = MskState(nco_phase, freq, slope, coarse_y, mf_state, agc_ema,
                         tail, theta_next, grid, grid_rate, have_refs,
                         diff_im, diff_re, mse)
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
        "theta": theta,
        "grid": grid,
        "clock_ppm": grid_rate / L * 1e6,
        "slip": slip,
        "scatter": scatter,
    }
    return new_state, out


class MskDemodulator:
    """Host wrapper: one VFO, streaming over blocks, on ``device``.

    Each block is one graphed ``msk_step`` on [1, block_len]
    (``utils/graphs.py``; ``cfg`` static): a CUDA-graph replay on a card,
    captured at the first block, the state in the step's static buffers.
    ``state`` reads a copy; assigning it writes the buffers in place (a
    retune captures nothing new)."""

    def __init__(self, fs: float, fb: float, device="cuda", **kw):
        self.cfg = make_config(fs, fb, **kw)
        self.device = resolve_device(device)
        self._step = GraphedStep(msk_step, msk_init(self.cfg, 1, self.device),
                                 "MskDemodulator msk_step")

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
# Modulator (numpy; for synthetic test vectors — the reference has none)
# ---------------------------------------------------------------------------

def msk_modulate(bits, fs: float, fb: float, freq: float = 1000.0,
                 amplitude: float = 0.25, phase0: float = 0.0) -> np.ndarray:
    """MSK-modulate a bit stream to real audio at ``fs``.

    CPM form: carrier phase ramps +-pi/2 per bit period.  The precoder
    inverts the demodulator's per-arm differential decode with its
    alternating-arm inversion (real arm negated), so the demodulated stream
    reproduces ``bits`` up to a bounded shift + polarity that the UW
    deframer absorbs.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    sps = int(fs / fb)
    e = np.empty_like(bits)
    prev = 0
    for k in range(len(bits)):
        cur = bits[k] ^ prev if (k % 2 == 0) else bits[k] ^ prev ^ 1
        e[k] = cur
        prev = cur
    d = 1.0 - 2.0 * e.astype(np.float64)
    phase_steps = np.repeat(d * (np.pi / 2.0) / sps, sps)
    phase = phase0 + np.concatenate([[0.0], np.cumsum(phase_steps)])[:-1]
    t = np.arange(len(phase))
    sig = amplitude * np.cos(2 * np.pi * freq / fs * t + phase)
    return sig.astype(np.float32)
