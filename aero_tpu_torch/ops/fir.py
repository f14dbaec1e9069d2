"""Streaming block FIR filtering (torch).

Counterpart of ``aero_tpu/ops/fir.py`` (``fir_init`` / ``fir_apply``).
The carry is the last ``ntaps-1`` inputs (overlap-save), so a stream cut
into blocks filters exactly like one long stream: the causal alignment
``y[n] = sum_k h[k] x[n-k]`` holds across block boundaries.  A complex
input with real taps is filtered as two real convolutions, as the JAX
``_corr_valid`` does.  On the card the convolution runs in cuDNN, which
must be held at full float32 (``device.set_fp32_precision``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _corr_valid_real(x, h):
    """Valid-mode correlation of real x [..., L] with h [K] -> [..., L-K+1]."""
    lead = x.shape[:-1]
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), h.reshape(1, 1, -1))
    return y.reshape(lead + (y.shape[-1],))


def _corr_valid(x, h):
    if x.is_complex():
        # real and imaginary parts as one batch of real rows
        both = torch.stack([x.real, x.imag])
        y = _corr_valid_real(both, h)
        return torch.complex(y[0], y[1])
    return _corr_valid_real(x, h)


def fir_init(ntaps: int, batch_shape=(), dtype=torch.float32, device="cpu"):
    """History carry: the last ntaps-1 inputs (zeros initially)."""
    return torch.zeros(batch_shape + (ntaps - 1,), dtype=dtype, device=device)


def fir_apply(state, x, taps):
    """Causal FIR: y[n] = sum_k h[k] x[n-k].  Returns (new_state, y[..., T]).

    ``taps``: real, numpy or tensor."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    k = taps.shape[0]
    xp = torch.cat([state, x], dim=-1)
    y = _corr_valid(xp, taps.flip(0))
    new_state = xp[..., -(k - 1):] if k > 1 else state
    return new_state, y
