"""Frozen plain copy of the oscillator helpers of
``aero_tpu_torch/ops/nco.py``, part of the benchmark's reference: plain
PyTorch, run eagerly, importing nothing of the port. The port may
change; this copy does not."""

from __future__ import annotations

import math

import numpy as np
import torch


def cis(angle: torch.Tensor) -> torch.Tensor:
    """exp(1j * angle) as complex64 (the JAX code's
    ``jnp.exp(1j * angle).astype(complex64)``)."""
    return torch.polar(torch.ones_like(angle), angle)


def nco_init(phase_cycles=0.0, device="cpu", batch_shape=()):
    """State = current phase in cycles, float32 of ``batch_shape``."""
    return torch.full(batch_shape, float(phase_cycles), dtype=torch.float32,
                      device=device)


def fused_mul_add(a, b, c):
    """``c + a * b`` in float32 with ONE rounding, as XLA's CPU backend
    computes that expression (it contracts it to a fused multiply-add).

    The product of two float32 values is exact in float64, and so is its
    sum with a float32 of a magnitude close enough (a phase ramp and its
    start phase), so rounding the float64 result once to float32 gives
    the fused result.  With two roundings a ramp of ~2700 cycles (an
    8 kHz mix over a 16000-sample block) is off by one float32 ulp,
    2.4e-4 cycles, on a third of its samples."""
    def wide(v):
        # a Python number is rounded to float32 first, as a weakly typed
        # constant is in JAX
        if isinstance(v, torch.Tensor):
            return v.double()
        return float(np.float32(v))
    return (wide(c) + wide(a) * wide(b)).to(torch.float32)


def nco_phase_ramp(state, freq_norm, length: int):
    """Return (new_state, phase ramp in cycles, shape [..., length]).

    ``freq_norm`` = f/Fs in cycles/sample, a tensor shaped like ``state``
    (or a Python float).  The ramp rounds ``state + f * n`` once, as the
    JAX version does on the CPU (``fused_mul_add``)."""
    freq_norm = torch.as_tensor(freq_norm, dtype=state.dtype,
                                device=state.device).expand(state.shape)
    n = torch.arange(length, dtype=state.dtype, device=state.device)
    ramp = fused_mul_add(freq_norm[..., None], n, state[..., None])
    new_state = torch.remainder(state + freq_norm * length, 1.0)
    return new_state, torch.remainder(ramp, 1.0)


def nco_mix(state, x, freq_norm, conj: bool = False, extra_cycles=None):
    """Mix a block by ``exp(+/- 2 pi j * (phi0 + f n [+ extra]))``.

    x: [..., T] complex or real.  ``extra_cycles`` [..., T] adds a
    per-sample phase (cycles) inside the single exp, as the JAX version
    does for the Doppler chirp.  Returns (new_state, mixed block)."""
    new_state, ramp = nco_phase_ramp(state, freq_norm, x.shape[-1])
    if extra_cycles is not None:
        ramp = torch.remainder(ramp + extra_cycles, 1.0)
    ang = (2.0 * math.pi) * ramp
    osc = cis(-ang if conj else ang)
    return new_state, x * osc
