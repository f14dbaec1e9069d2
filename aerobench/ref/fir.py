"""Frozen plain copy of the FIR helpers of ``aero_tpu_torch/ops/fir.py``,
part of the benchmark's reference: plain PyTorch, run eagerly, importing
nothing of the port. The port may change; this copy does not."""

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


def convolve_same(x, k):
    """``jnp.convolve(x, k, mode="same")`` along the last axis of x
    [..., N] (real or complex) with a real kernel k [M], M <= N.

    "same" keeps the N samples of the full convolution from index
    (M-1)//2 on, the numpy alignment: for an even M the window is one
    sample later than a symmetric ``conv1d`` padding of M//2 a side would
    give.  So the input is padded by M//2 on the left and (M-1)//2 on the
    right, and correlated with the flipped kernel."""
    if x.is_complex():
        return torch.complex(convolve_same(x.real, k), convolve_same(x.imag, k))
    M = k.shape[0]
    lead = x.shape[:-1]
    xb = F.pad(x.reshape(-1, 1, x.shape[-1]), (M // 2, (M - 1) // 2))
    y = F.conv1d(xb, k.flip(0).reshape(1, 1, -1))
    return y.reshape(lead + (y.shape[-1],))


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


def fir_decimate_init(ntaps: int, batch_shape=(), dtype=torch.float32,
                      device="cpu"):
    return torch.zeros(batch_shape + (ntaps - 1,), dtype=dtype, device=device)


def fir_decimate_apply(state, x, taps, factor: int):
    """Causal FIR followed by keep-every-``factor``-th sample: output m is
    the filter evaluated at input index m*factor.  The block length must
    be a multiple of ``factor`` (ValueError otherwise), so the carry (the
    last ntaps-1 inputs) keeps the decimation phase across blocks."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    k = taps.shape[0]
    if x.shape[-1] % factor:
        raise ValueError(f"block length {x.shape[-1]} not divisible by "
                         f"{factor}")
    xp = torch.cat([state, x], dim=-1)
    lead = xp.shape[:-1]
    h = taps.flip(0).reshape(1, 1, -1)

    def conv(z):
        return F.conv1d(z.reshape(-1, 1, z.shape[-1]), h, stride=factor)

    if xp.is_complex():
        y = conv(torch.stack([xp.real, xp.imag]))
        y = torch.complex(y[: y.shape[0] // 2], y[y.shape[0] // 2:])
    else:
        y = conv(xp)
    y = y.reshape(lead + (y.shape[-1],))
    new_state = xp[..., -(k - 1):] if k > 1 else state
    return new_state, y


def delay_init(n: int, batch_shape=(), dtype=torch.float32, device="cpu"):
    """Integer delay line state (the reference's DelayThing)."""
    return torch.zeros(batch_shape + (n,), dtype=dtype, device=device)


def delay_apply(state, x):
    """Delay the block by ``state.shape[-1]`` samples."""
    n = state.shape[-1]
    xp = torch.cat([state, x], dim=-1)
    return xp[..., -n:] if n else state, xp[..., : x.shape[-1]]


def halfband_cascade_init(n_stages: int, ntaps: int, batch_shape=(),
                          dtype=torch.complex64, device="cpu"):
    return [fir_decimate_init(ntaps, batch_shape, dtype, device)
            for _ in range(n_stages)]


def halfband_cascade_apply(states, x, taps):
    """Run a 2:1 halfband decimator ``len(states)`` times (block length a
    multiple of 2**len(states))."""
    new_states = []
    for st in states:
        st, x = fir_decimate_apply(st, x, taps, 2)
        new_states.append(st)
    return new_states, x


def fir_apply_fft(state, x, taps):
    """Causal FIR by FFT convolution, for long kernels (the 2049-tap RRC
    of the 8400 bps demodulator).  Same contract as ``fir_apply``:
    returns (new_state, y[..., T]), the carry is the last ntaps-1 inputs.

    The JAX version is ``jss.fftconvolve(state ++ x, taps, "valid")``:
    of the full convolution of the N = ntaps-1+T inputs it keeps the T
    samples from index ntaps-1 on, each of which sees ntaps real inputs.
    Here the transform length is the next power of two of the full
    length N+ntaps-1 (JAX uses the full length itself), so the values
    agree to float32 FFT error, not bit for bit."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    k = taps.shape[0]
    xp = torch.cat([state, x], dim=-1)
    full = xp.shape[-1] + k - 1
    nfft = 1 << (full - 1).bit_length()
    if xp.is_complex():
        spec = torch.fft.fft(xp, n=nfft) * torch.fft.fft(
            taps.to(xp.dtype), n=nfft)
        y = torch.fft.ifft(spec, n=nfft)
    else:
        spec = torch.fft.rfft(xp, n=nfft) * torch.fft.rfft(taps, n=nfft)
        y = torch.fft.irfft(spec, n=nfft)
    y = y[..., k - 1: k - 1 + x.shape[-1]]
    new_state = xp[..., -(k - 1):] if k > 1 else state
    return new_state, y
