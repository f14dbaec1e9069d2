"""Frozen plain copy of the block statistics of
``aero_tpu_torch/ops/stats.py``, part of the benchmark's reference:
plain PyTorch, run eagerly, importing nothing of the port. The port may
change; this copy does not."""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)
_LOG10_2 = math.log10(2.0)


def block_agc(ema_state, x_abs, alpha=0.1):
    """Return (new_ema, gain): gain = sqrt(2) / mean(|x|) with an
    exponential carry across blocks (ref decode/DSP.cpp:358-385)."""
    m = torch.mean(x_abs, dim=-1)
    init = ema_state <= 0.0
    new_ema = torch.where(init, m, (1.0 - alpha) * ema_state + alpha * m)
    gain = _SQRT2 / torch.clamp(new_ema, min=1e-6)
    return new_ema, torch.clamp(gain, min=1e-6)


def moving_average_init(batch_shape=(), device="cpu", dtype=torch.float32):
    return torch.zeros(batch_shape, dtype=dtype, device=device)


def moving_average_apply(state, x, alpha):
    """EMA over the trailing axis, returning (last, per-sample values):
    y[n] = (1-alpha) y[n-1] + alpha x[n], carried across blocks through
    ``state`` (ref MovingAverage, decode/DSP.cpp:392-430).

    A log-depth (Hillis-Steele) scan of JAX's ``associative_scan``
    combine on (decay, value) pairs, y = decay * y_prev + value.  A
    cumulative sum scaled by (1-alpha)^-n would overflow float32 after a
    few hundred samples.  The tree differs from XLA's, so the two agree to
    float32 rounding, not bit for bit."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    d = torch.full_like(x, 1.0) - a
    v = a * x
    # the carried state is the "previous" value of the first sample
    v = torch.cat([v[..., :1] + (1.0 - a) * state[..., None], v[..., 1:]],
                  dim=-1)
    s = 1
    while s < x.shape[-1]:
        v = torch.cat([v[..., :s], v[..., s:] + d[..., s:] * v[..., :-s]],
                      dim=-1)
        d = torch.cat([d[..., :s], d[..., s:] * d[..., :-s]], dim=-1)
        s *= 2
    return v[..., -1], v


def msk_ebno(mean, var):
    """MSK Eb/N0 estimate from matched-filter envelope mean/var
    (ref decode/DSP.cpp:482-508)."""
    alpha = _SQRT2 / torch.clamp(mean, min=1e-9)
    arg = var * alpha * alpha - 0.0085
    tebno = 10.0 * (_LOG10_2 - torch.log10(torch.clamp(arg, min=1e-9))) - 5.0
    return torch.clamp(torch.nan_to_num(tebno, nan=50.0), -20.0, 50.0)
