"""Port parity: aero_tpu_torch.ops against aero_tpu.ops (JAX on the CPU).

Inputs are made once from a numpy seed and fed to both.  Tolerance:
rtol = atol = 1e-5 — float32 ops whose only difference is the summation
order and the exp/sin/cos implementations (a few ulp on unit-scale
values).  The JAX side runs under ``jax.jit``, as the demodulators run
it: compiled, XLA rounds ``phase + f * n`` once (a fused multiply-add),
which the port's ramp reproduces; eager JAX rounds twice."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.ops import nco as jnco, fir as jfir, stats as jstats
from aero_tpu_torch.ops import nco as tnco, fir as tfir, stats as tstats

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _c(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("freq,extra,conj", [
    (0.0123, False, False),
    (-0.2071, False, True),      # negative frequency: floor-mod, not fmod
    (0.0417, True, True),        # chirp cycles inside the exp
])
def test_nco_mix(freq, extra, conj):
    rng = np.random.default_rng(1)
    B, T = 3, 1000
    phase = rng.uniform(0, 1, B).astype(np.float32)
    fn = (freq * (1.0 + 0.1 * np.arange(B))).astype(np.float32)
    x = _c(rng, B, T)
    ex = (np.cumsum(rng.uniform(-1e-3, 1e-3, (B, T)), axis=1)
          .astype(np.float32) if extra else None)
    mix = jax.jit(jnco.nco_mix, static_argnames="conj")
    jp, jy = mix(jnp.asarray(phase), jnp.asarray(x), jnp.asarray(fn),
                 conj=conj,
                 extra_cycles=None if ex is None else jnp.asarray(ex))
    tp, ty = tnco.nco_mix(torch.from_numpy(phase), torch.from_numpy(x),
                          torch.from_numpy(fn), conj=conj,
                          extra_cycles=None if ex is None else
                          torch.from_numpy(ex))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert (tp.numpy() >= 0).all() and (tp.numpy() < 1).all()


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_apply_three_blocks_with_carry(cplx):
    rng = np.random.default_rng(2)
    taps = rng.standard_normal(40).astype(np.float32)
    B, T = 2, 800
    js = jfir.fir_init(40, (B,), jnp.complex64 if cplx else jnp.float32)
    ts = tfir.fir_init(40, (B,), torch.complex64 if cplx else torch.float32)
    for _ in range(3):
        x = _c(rng, B, T) if cplx else \
            rng.standard_normal((B, T)).astype(np.float32)
        js, jy = jfir.fir_apply(js, jnp.asarray(x), jnp.asarray(taps))
        ts, ty = tfir.fir_apply(ts, torch.from_numpy(x), taps)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_fir_apply_is_causal_across_blocks():
    """Blockwise filtering equals one long causal convolution."""
    rng = np.random.default_rng(3)
    taps = rng.standard_normal(17).astype(np.float32)
    x = rng.standard_normal(3000).astype(np.float32)
    st = tfir.fir_init(17)
    ys = []
    for i in range(0, 3000, 1000):
        st, y = tfir.fir_apply(st, torch.from_numpy(x[i:i + 1000]), taps)
        ys.append(y.numpy())
    ref = np.convolve(x.astype(np.float64), taps.astype(np.float64))[:3000]
    np.testing.assert_allclose(np.concatenate(ys), ref, rtol=1e-5,
                               atol=1e-4)


def test_block_agc_and_msk_ebno():
    rng = np.random.default_rng(4)
    ema = np.asarray([0.0, 0.5, 1.3], np.float32)
    xa = np.abs(rng.standard_normal((3, 5000))).astype(np.float32)
    je, jg = jstats.block_agc(jnp.asarray(ema), jnp.asarray(xa))
    te, tg = tstats.block_agc(torch.from_numpy(ema), torch.from_numpy(xa))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    mean = np.asarray([1.0, 0.3, 2.0, 0.0], np.float32)
    var = np.asarray([0.01, 0.2, 0.0, 0.5], np.float32)
    jv = jstats.msk_ebno(jnp.asarray(mean), jnp.asarray(var))
    tv = tstats.msk_ebno(torch.from_numpy(mean), torch.from_numpy(var))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
