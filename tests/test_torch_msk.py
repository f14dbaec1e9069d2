"""Port parity: the MSK demodulator and its coarse-frequency estimator.

``msk_step`` is compared TEACHER-FORCED: before every block the JAX state
is carried into the port (``convert``), both step the same samples, and
the outputs and new states are compared; then JAX advances.  An argmax
that flips on a near-tie can thus cost one block, never compound.

Tolerances, and why:
- soft bytes: within +-1 on >= 99.9% of each block's bytes (half-to-even
  rounding on both sides; a byte moves by one where the pre-round value
  sits on a .5 boundary within float32 error — measured: at most one
  byte in 800 of a block);
- have_lock_refs: exact;
- phases (nco_phase in cycles, theta in rad), compared circularly: 2e-4
  cycles / 5e-3 rad.  The mixer ramp reaches ~700 cycles per block in
  float32 (ulp 6e-5 cycles) and the chirp cumsum sums in another order
  than XLA's, so a 1-2 ulp difference in the ramp is expected;
- frequencies and slope: 2e-3 Hz (Hz/s) + 1e-4 relative; strobe grid and
  rate: 2e-3 samples; diff-decoder memories: 5e-3;
- complex carries (matched-filter history, strobe tail; magnitudes up to
  the 2.84 clip): 1e-2 absolute;
- the smoothed dB fold spectrum: 0.25 dB (near its -40 dB floor the
  peak-normalized magnitudes are tiny, and a relative float32 error
  becomes a few hundredths of a dB);
- AGC carry and constellation MSE: 1e-4 relative.
"""

import os
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.models import msk as jm
from aero_tpu.models.coarse_freq import (coarse_freq_estimate as j_cfe,
                                         coarse_freq_init as j_cfi)
from aero_tpu.protocol.framing import PChannelFramer as JFramer
from aero_tpu.protocol.framing import build_p_frames
from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu_torch import convert
from aero_tpu_torch.models import msk as tm
from aero_tpu_torch.models.coarse_freq import (coarse_freq_estimate as t_cfe,
                                               coarse_freq_init as t_cfi)
from aero_tpu_torch.protocol.framing import PChannelFramer as TFramer
from tests.test_impairments import impair

torch.set_num_threads(2)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _modem_signal(fs, fb, cfo, snr, seed=7, nfields=3):
    """The tests/test_msk_modem.py round-trip signal."""
    rng = np.random.default_rng(seed)
    fields = [b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9)))) for _ in range(6))
        for _ in range(nfields)]
    bits = build_p_frames(fields, int(fb), lead_frames=4)
    sig = jm.msk_modulate(bits, fs, fb, freq=1000.0 + cfo)
    p = np.mean(sig ** 2)
    return (sig + rng.normal(0, np.sqrt(p / 10 ** (snr / 10)), len(sig))
            ).astype(np.float32)


def _circ(a, b, period):
    return np.abs((a - b + period / 2) % period - period / 2)


def _check_state(tn, jn, ctx):
    """Compare the port's batched state with a JAX state (numpy leaves,
    same batch layout)."""
    t = {f: getattr(tn, f).numpy() for f in tm.MskState._fields}
    j = {f: np.asarray(getattr(jn, f)).reshape(t[f].shape)
         for f in tm.MskState._fields}
    np.testing.assert_array_equal(t["have_lock_refs"], j["have_lock_refs"],
                                  err_msg=ctx)
    assert _circ(t["nco_phase"], j["nco_phase"], 1.0).max() < 2e-4, ctx
    assert _circ(t["theta"], j["theta"], 2 * np.pi).max() < 5e-3, ctx
    for f in ("freq", "slope"):
        np.testing.assert_allclose(t[f], j[f], rtol=1e-4, atol=2e-3,
                                   err_msg=f"{ctx} {f}")
    for f in ("grid", "grid_rate"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=2e-3,
                                   err_msg=f"{ctx} {f}")
    for f in ("diff_im", "diff_re"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=5e-3,
                                   err_msg=f"{ctx} {f}")
    for f in ("mf_state", "tail"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=1e-2,
                                   err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(t["coarse_y"], j["coarse_y"], rtol=0,
                               atol=0.25, err_msg=f"{ctx} coarse_y")
    for f in ("agc_ema", "mse"):
        np.testing.assert_allclose(t[f], j[f], rtol=1e-4, atol=1e-9,
                                   err_msg=f"{ctx} {f}")


def _check_soft(ts, js, ctx):
    d = np.abs(ts.astype(np.int32) - js.astype(np.int32))
    assert (d <= 1).mean() >= 0.999, (ctx, (d > 1).mean(), d.max())


def _teacher_forced(x, fs, fb, n_blocks):
    """x: [B, n] audio; JAX vmaps msk_step over B, the port batches."""
    cfg_j = jm.make_config(fs, fb)
    cfg_t = tm.make_config(fs, fb)
    L = cfg_j.block_len
    B = x.shape[0]
    js = jax.vmap(lambda _: jm.msk_init(cfg_j))(jnp.arange(B))
    step = jax.jit(jax.vmap(lambda s, a: jm.msk_step(s, a, cfg_j)))
    assert x.shape[1] >= n_blocks * L
    for i in range(n_blocks):
        blk = x[:, i * L:(i + 1) * L]
        jn, jo = step(js, jnp.asarray(blk))
        ts = convert.msk_state_from_numpy(jax.tree.map(np.asarray, js))
        tn, to = tm.msk_step(ts, torch.from_numpy(blk), cfg_t)
        ctx = f"block {i}"
        _check_soft(to["soft_bits"].numpy(), np.asarray(jo["soft_bits"]),
                    ctx)
        np.testing.assert_array_equal(to["slip"].numpy(),
                                      np.asarray(jo["slip"]), err_msg=ctx)
        np.testing.assert_array_equal(to["signal"].numpy(),
                                      np.asarray(jo["signal"]), err_msg=ctx)
        _check_state(tn, jax.tree.map(np.asarray, jn), ctx)
        js = jn


@pytest.mark.parametrize("fs,fb,cfo,snr", [
    (24000, 1200, 77.0, 6.0),
    (12000, 600, 150.0, 3.0),
    (48000, 1200, 300.0, 12.0),
])
def test_msk_step_teacher_forced_modem(fs, fb, cfo, snr):
    x = _modem_signal(fs, fb, cfo, snr)
    _teacher_forced(x[None], float(fs), float(fb), n_blocks=7)


@pytest.mark.parametrize("impairment", [dict(cfo0=-500.0, ramp=25.0),
                                        dict(ppm=-200.0)])
def test_msk_step_teacher_forced_impairments(impairment):
    """A Doppler ramp and a sample-clock offset of
    tests/test_impairments.py (the slope tracker, chirp derotation,
    second-order timing loop and slip flag are all exercised)."""
    x = _modem_signal(24000, 1200, 0.0, 20.0, seed=3, nfields=4)
    x = impair(x, 24000, **impairment)
    _teacher_forced(x[None], 24000.0, 1200.0, n_blocks=8)


def test_msk_step_teacher_forced_batched_vs_vmap():
    """B=3 VFOs with different offsets and SNRs against JAX vmap."""
    xs = [_modem_signal(24000, 1200, c, s, seed=k)
          for k, (c, s) in enumerate([(-120.0, 8.0), (0.0, 30.0),
                                      (210.0, 12.0)])]
    n = min(len(v) for v in xs)
    _teacher_forced(np.stack([v[:n] for v in xs]), 24000.0, 1200.0,
                    n_blocks=6)


def test_coarse_freq_estimate():
    rng = np.random.default_rng(5)
    fs, fb, nfft = 24000.0, 1200.0, 8192
    x = _modem_signal(24000, 1200, 140.0, 10.0)[:3 * nfft]
    n = np.arange(len(x))
    bb = (x * np.exp(-2j * np.pi * 1000.0 / fs * n)).astype(np.complex64)
    jy, ty = j_cfi(nfft, (2,)), t_cfi(nfft, (2,))
    for k in range(3):
        blk = np.stack([bb[k * nfft:(k + 1) * nfft],
                        (rng.standard_normal(nfft)
                         + 1j * rng.standard_normal(nfft)).astype(
                             np.complex64)])
        # teacher-forced: both sides get the JAX carry
        jy2, jest = j_cfe(jy, jnp.asarray(blk), nfft=nfft, fb=fb, fs=fs,
                          lockingbw=900.0)
        ty2, test = t_cfe(torch.from_numpy(np.array(jy)),
                          torch.from_numpy(blk), nfft=nfft, fb=fb, fs=fs,
                          lockingbw=900.0)
        np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), rtol=0,
                                   atol=0.25)
        np.testing.assert_array_equal(test.numpy(), np.asarray(jest))
        jy, ty = jy2, ty2
    assert abs(float(test[0]) - 140.0) < 2 * fs / nfft


def test_free_running_fixture_same_frames():
    """Free-running (no teacher forcing) decode of the shipped 1200 bps
    fixture: the port's demod + framer give the same frames as JAX's,
    and every expected ACARS message comes out of the port's chain."""
    import json
    from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher

    with wave.open(os.path.join(FIXDIR, "synthetic_1200.wav")) as w:
        fs = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    x = np.concatenate([pcm.astype(np.float32) / 32768.0,
                        np.zeros(32000, np.float32)])

    jouts = jm.MskDemodulator(fs, 1200).process(x)
    cfg = tm.make_config(float(fs), 1200.0)
    ts = tm.msk_init(cfg)
    jf, tf = JFramer(1200), TFramer(1200)
    jev, tev = [], []
    for i, jo in enumerate(jouts):
        blk = x[i * cfg.block_len:(i + 1) * cfg.block_len]
        ts, to = tm.msk_step(ts, torch.from_numpy(blk)[None], cfg)
        jev += jf.feed(jo["soft_bits"].astype(np.float32),
                       slip=int(jo["slip"]))
        tev += tf.feed(to["soft_bits"][0].numpy().astype(np.float32),
                       slip=int(to["slip"][0]))
    assert len(tev) == len(jev) > 0
    for a, b in zip(tev, jev):
        assert a.infofield == b.infofield and a.su_crc_ok == b.su_crc_ok

    items = []
    disp = PChannelSUDispatcher(on_acars=items.append)
    for ev in tev:
        for k, ok in enumerate(ev.su_crc_ok):
            if ok:
                disp.dispatch(ev.infofield[k * 12:(k + 1) * 12])
    with open(os.path.join(FIXDIR, "synthetic_1200.expected.jsonl")) as f:
        want = {json.loads(line)["isu"]["acars"]["msg_text"] for line in f}
    assert want and want <= {it.message for it in items}


def test_acquisition_mse_gap_on_noise_is_the_tone_sync_angles():
    """Why an acquiring demod's mse differs from JAX's on noise (the gap
    of tests/test_torch_parallel.py's first blocks).

    From ``msk_init`` on noise, at the fused station's MSK 1200 shape
    (160-sample blocks, nfft 128), fed the same input op by op, every op
    before ``_tone_pair_sync`` agrees to float32: the mixer, the coarse
    fold spectrum and its argmax, the matched filter, the AGC mean and
    the tone-grid GEMM (all within 1e-6).  ``_tone_pair_sync``'s
    estimates are angles of noise-floor tone coefficients (the half-block
    phase-slope refine of nu, theta0 = angle(a_p a_m) / 4, t0 = -angle(a_p
    conj(a_m)) / 2 pi), which turn that 1e-7 into ~1e-3 rad of carrier
    phase and ~1e-3 samples of strobe grid, and the constellation mse
    moves by up to 5e-4 relative.  JAX moves by the same order against
    itself when its input moves by one float32 ulp: the gap is float32
    summation order amplified by the estimator's conditioning, not a
    fault the port can remove.  Bounds: mse 1e-3 relative, theta0 5e-3
    rad, grid 1e-2 samples; from the second block on the rows agree to
    1e-4 (tests/test_torch_cuda.py:check_packed)."""
    from aero_tpu.ops import fir as jfir, stats as jstats
    from aero_tpu.ops.design import msk_matched_filter
    from aero_tpu_torch.ops import fir as tfir, stats as tstats

    fs, fb, L, nfft, B = 24000.0, 1200.0, 160, 128, 64
    cj = jm.make_config(fs, fb, block_len=L, nfft=nfft)
    ct = tm.make_config(fs, fb, block_len=L, nfft=nfft)
    x = np.random.default_rng(0).standard_normal((2, B, L)).astype(
        np.float32)
    js = jax.vmap(lambda _: jm.msk_init(cj))(jnp.arange(B))
    step = jax.jit(jax.vmap(lambda s, a: jm.msk_step(s, a, cj)))

    # op by op on block 0, the same input into both
    bb = tm.nco_mix(torch.zeros(B), torch.from_numpy(x[0]).to(
        torch.complex64), torch.full((B,), ct.freq_center / fs),
        conj=True)[1]
    jy, jd = j_cfe(j_cfi(nfft, (B,)), jnp.asarray(bb.numpy()), nfft=nfft,
                   fb=fb, fs=fs, lockingbw=cj.lockingbw)
    ty, td = t_cfe(t_cfi(nfft, (B,)), bb, nfft=nfft, fb=fb, fs=fs,
                   lockingbw=ct.lockingbw)
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-4
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    taps = np.asarray(msk_matched_filter(ct.sps), np.float32)
    h0 = np.zeros((B, 2 * ct.sps - 1), np.complex64)
    jmf = np.asarray(jax.jit(jax.vmap(jfir.fir_apply, in_axes=(0, 0, None)))(
        jnp.asarray(h0), jnp.asarray(bb.numpy()), jnp.asarray(taps))[1])
    tmf = tfir.fir_apply(torch.from_numpy(h0), bb, taps)[1].numpy()
    assert np.abs(tmf - jmf).max() <= 1e-6 * np.abs(jmf).max()
    jg = np.asarray(jstats.block_agc(jnp.zeros(B), jnp.abs(jmf))[1])
    tg = tstats.block_agc(torch.zeros(B), torch.from_numpy(np.abs(jmf)))[1]
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6)
    y = jmf * jg[:, None]
    y = np.where(np.abs(y) > 2.84,
                 y * (2.84 / np.maximum(np.abs(y), 1e-9)), y).astype(
        np.complex64)
    span, stp = ct.fine_span_hz / fs, ct.fine_step_hz / fs
    _, tw = jm._tone_grid(L, fb / fs, span, stp)
    jc = np.einsum("ct,bt->bc", tw, y * y)
    tc = (torch.from_numpy(y * y) @ torch.from_numpy(tw.T.copy())).numpy()
    assert np.abs(tc - jc).max() <= 1e-6 * np.abs(jc).max()
    j_th = np.asarray(jax.vmap(lambda v: jm._tone_pair_sync(
        v, fb / fs, span, stp))(jnp.asarray(y))[1])
    t_th = tm._tone_pair_sync(torch.from_numpy(y), fb / fs, span,
                              stp)[1].numpy()
    assert _circ(t_th, j_th, np.pi / 2).max() < 5e-3

    # the whole step, two blocks from msk_init, teacher-forced
    gaps, own = [], []
    for blk in x:
        jn, jout = step(js, jnp.asarray(blk))
        ulp = np.nextafter(blk, np.sign(blk) * np.float32(np.inf))
        own_mse = np.asarray(step(js, jnp.asarray(ulp))[1]["mse"])
        ts = convert.msk_state_from_numpy(jax.tree.map(np.asarray, js))
        _, tout = tm.msk_step(ts, torch.from_numpy(blk), ct)
        want = np.asarray(jout["mse"])
        gaps.append(np.abs(tout["mse"].numpy() - want) / want)
        own.append(np.abs(own_mse - want) / want)
        np.testing.assert_allclose(tout["grid"].numpy(),
                                   np.asarray(jout["grid"]), rtol=0,
                                   atol=1e-2)
        _check_soft(tout["soft_bits"].numpy(),
                    np.asarray(jout["soft_bits"]), "acquisition")
        np.testing.assert_array_equal(tout["signal"].numpy(),
                                      np.asarray(jout["signal"]))
        js = jn
    assert max(g.max() for g in gaps) <= 1e-3, [g.max() for g in gaps]
    assert max(o.max() for o in own) > 1e-5, [o.max() for o in own]
