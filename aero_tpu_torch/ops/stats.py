"""Block statistics: AGC and MSK Eb/N0 estimation (torch).

Counterpart of ``aero_tpu/ops/stats.py`` (``block_agc``, ``msk_ebno``).
"""

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


def msk_ebno(mean, var):
    """MSK Eb/N0 estimate from matched-filter envelope mean/var
    (ref decode/DSP.cpp:482-508)."""
    alpha = _SQRT2 / torch.clamp(mean, min=1e-9)
    arg = var * alpha * alpha - 0.0085
    tebno = 10.0 * (_LOG10_2 - torch.log10(torch.clamp(arg, min=1e-9))) - 5.0
    return torch.clamp(torch.nan_to_num(tebno, nan=50.0), -20.0, 50.0)
