"""Port parity: the OQPSK demodulator (10500 P channel, 8400 C channel),
its FFT matched filter, and the C-channel framer on the port's soft bits.

``oqpsk_step`` is compared TEACHER-FORCED, as ``msk_step`` is in
tests/test_torch_msk.py: before every block the JAX state is carried into
the port (``convert``), both step the same samples, then JAX advances.
JAX runs ``jax.vmap(oqpsk_step)`` over B=2 VFOs; the port's step is
batched.

Tolerances, and why:
- ``fir_apply_fft`` (2049 taps): 1e-4 of the output's peak — float32 FFT
  convolutions of two libraries at two transform lengths (the port pads
  to a power of two); the carry (raw inputs) is exact;
- soft bytes: within +-1 on >= 99.9% of a block's bytes AND equal on
  >= 99%.  The mixer ramp is rounded once as XLA rounds it (a fused
  multiply-add), so what is left is float32 summation order (tone-grid
  GEMMs, the FFT filter at 8400) moving a byte across a .5 boundary;
- have_lock_refs and slips: exact;
- mse: 1e-4 relative; freq: 2e-3 Hz (two float32 ulps at 8 kHz);
- the mixer's end phase: 2.5e-4 cycles, circularly — one float32 ulp of
  the ~2700-cycle ramp end of an 8 kHz mix (XLA folds (f/fs)*L into
  f*(L/fs) before its fused add; the port does not follow it there);
- the other carries as in tests/test_torch_msk.py (theta circularly
  5e-3 rad; grid 2e-3 samples; complex carries 1e-2; the dB fold
  spectrum 0.25 dB; AGC 1e-4 relative).
Free-running, the port decodes tests/fixtures/synthetic_10500.wav to its
expected messages with the same frames as JAX, and the 8400 round trips
of tests/test_c_channel.py to the same voice frames as JAX.
"""

import functools
import json
import os
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.models import oqpsk as jo
from aero_tpu.ops import fir as jfir
from aero_tpu.protocol.c_framing import CChannelFramer as JCFramer
from aero_tpu.protocol.c_framing import build_c_frames
from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu.protocol.framing import FRAME_SPECS, build_p_frames
from aero_tpu.protocol.framing import PChannelFramer as JFramer
from aero_tpu_torch import convert
from aero_tpu_torch.models import oqpsk as to
from aero_tpu_torch.ops import fir as tfir
from aero_tpu_torch.protocol.c_framing import CChannelFramer as TCFramer
from aero_tpu_torch.protocol.framing import PChannelFramer as TFramer
from tests.test_c_channel import _frames as c_frames
from tests.test_torch_msk import _check_soft, _circ

torch.set_num_threads(2)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def test_fir_apply_fft_three_blocks_with_carry():
    rng = np.random.default_rng(11)
    taps = to.root_raised_cosine(0.6, 2049, 48000.0, 4200.0).astype(
        np.float32)
    B, T = 2, 16000
    js = jfir.fir_init(2049, (B,), jnp.complex64)
    ts = tfir.fir_init(2049, (B,), torch.complex64)
    jfft = jax.jit(jax.vmap(jfir.fir_apply_fft, in_axes=(0, 0, None)))
    for _ in range(3):
        x = (rng.standard_normal((B, T))
             + 1j * rng.standard_normal((B, T))).astype(np.complex64)
        js, jy = jfft(js, jnp.asarray(x), jnp.asarray(taps))
        ts, ty = tfir.fir_apply_fft(ts, torch.from_numpy(x), taps)
        jy = np.asarray(jy)
        assert ty.shape == jy.shape and ty.dtype == torch.complex64
        assert np.abs(ty.numpy() - jy).max() <= 1e-4 * np.abs(jy).max()
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and the same filter as the direct (conv1d) one
    _, yd = tfir.fir_apply(ts, torch.from_numpy(x), taps)
    _, yf = tfir.fir_apply_fft(ts, torch.from_numpy(x), taps)
    assert (yd - yf).abs().max() <= 1e-4 * yd.abs().max()


def _p_signal(rng, nfields=2):
    nsu = FRAME_SPECS[10500].payload_info_bits // 96
    fields = [b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9)))) for _ in range(nsu))
        for _ in range(nfields)]
    return build_p_frames(fields, 10500, lead_frames=2)


def _two_vfos(fb, seed):
    """[2, n] audio at 48 kS/s: two VFOs of one bit stream at different
    offsets and SNRs."""
    rng = np.random.default_rng(seed)
    bits = (_p_signal(rng) if fb == 10500
            else build_c_frames(c_frames(rng, 2), lead_frames=1))
    xs = []
    for cfo, snr in ((-150.0, 12.0), (220.0, 20.0)):
        s = jo.oqpsk_modulate(bits, 48000, fb, freq=8000.0 + cfo)
        p = np.mean(s ** 2)
        xs.append((s + rng.normal(0, np.sqrt(p / 10 ** (snr / 10)), len(s))
                   ).astype(np.float32))
    n = min(len(v) for v in xs)
    return np.stack([v[:n] for v in xs])


def _check_state(tn, jn, ctx):
    t = {f: getattr(tn, f).numpy() for f in to.OqpskState._fields}
    j = {f: np.asarray(getattr(jn, f)) for f in to.OqpskState._fields}
    np.testing.assert_array_equal(t["have_lock_refs"], j["have_lock_refs"],
                                  err_msg=ctx)
    np.testing.assert_allclose(t["mse"], j["mse"], rtol=1e-4, atol=1e-9,
                               err_msg=f"{ctx} mse")
    np.testing.assert_allclose(t["freq"], j["freq"], rtol=0, atol=2e-3,
                               err_msg=f"{ctx} freq")
    np.testing.assert_allclose(t["slope"], j["slope"], rtol=1e-4, atol=2e-3,
                               err_msg=f"{ctx} slope")
    assert _circ(t["nco_phase"], j["nco_phase"], 1.0).max() < 2.5e-4, ctx
    assert _circ(t["theta"], j["theta"], 2 * np.pi).max() < 5e-3, ctx
    for f in ("grid", "grid_rate"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=2e-3,
                                   err_msg=f"{ctx} {f}")
    for f in ("mf_state", "tail"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=1e-2,
                                   err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(t["coarse_y"], j["coarse_y"], rtol=0,
                               atol=0.25, err_msg=f"{ctx} coarse_y")
    np.testing.assert_allclose(t["agc_ema"], j["agc_ema"], rtol=1e-4,
                               atol=1e-9, err_msg=f"{ctx} agc_ema")


@pytest.mark.parametrize("fb", [10500, 8400])
def test_oqpsk_step_teacher_forced(fb):
    x = _two_vfos(fb, seed=7)
    cfg_j = jo.make_config(48000.0, float(fb))
    cfg_t = to.make_config(48000.0, float(fb))
    assert tuple(cfg_t) == tuple(cfg_j)
    L = cfg_j.block_len
    js = jax.vmap(lambda _: jo.oqpsk_init(cfg_j))(jnp.arange(2))
    step = jax.jit(jax.vmap(lambda s, a: jo.oqpsk_step(s, a, cfg_j)))
    locked = 0
    for b in range(4):
        blk = x[:, b * L:(b + 1) * L]
        jn, jout = step(js, jnp.asarray(blk))
        ts = convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                      to.OqpskState)
        tn, tout = to.oqpsk_step(ts, torch.from_numpy(blk), cfg_t)
        ctx = f"fb {fb} block {b}"
        ts_b = tout["soft_bits"].numpy()
        js_b = np.asarray(jout["soft_bits"])
        assert ts_b.dtype == np.uint8 and ts_b.shape == js_b.shape
        _check_soft(ts_b, js_b, ctx)
        assert (ts_b == js_b).mean() >= 0.99, (ctx, (ts_b == js_b).mean())
        np.testing.assert_array_equal(tout["slip"].numpy(),
                                      np.asarray(jout["slip"]), err_msg=ctx)
        np.testing.assert_array_equal(tout["signal"].numpy(),
                                      np.asarray(jout["signal"]), err_msg=ctx)
        _check_state(tn, jax.tree.map(np.asarray, jn), ctx)
        locked += int(tn.have_lock_refs.sum())
        js = jn
    assert locked > 0, "the forced blocks never locked"


def test_fixture_10500_decodes_same_frames_as_jax():
    """Free-running decode of the shipped 10500 bps fixture: the same
    frames as JAX's chain, and every expected ACARS message."""
    from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher

    with wave.open(os.path.join(FIXDIR, "synthetic_10500.wav")) as w:
        fs = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    x = np.concatenate([pcm.astype(np.float32) / 32768.0,
                        np.zeros(32000, np.float32)])
    jouts = jo.OqpskDemodulator(fs, 10500).process(x)
    touts = to.OqpskDemodulator(fs, 10500, device="cpu").process(x)
    assert len(touts) == len(jouts) > 0
    jf, tf = JFramer(10500), TFramer(10500)
    jev, tev = [], []
    for jo_, to_ in zip(jouts, touts):
        assert to_["soft_bits"].shape == jo_["soft_bits"].shape
        jev += jf.feed(jo_["soft_bits"].astype(np.float32),
                       slip=int(jo_["slip"]))
        tev += tf.feed(to_["soft_bits"].astype(np.float32),
                       slip=int(to_["slip"]))
    assert len(tev) == len(jev) > 0
    for a, b in zip(tev, jev):
        assert a.infofield == b.infofield and a.su_crc_ok == b.su_crc_ok

    items = []
    disp = PChannelSUDispatcher(on_acars=items.append)
    for ev in tev:
        for k, ok in enumerate(ev.su_crc_ok):
            if ok:
                disp.dispatch(ev.infofield[k * 12:(k + 1) * 12])
    with open(os.path.join(FIXDIR, "synthetic_10500.expected.jsonl")) as f:
        want = {json.loads(line)["isu"]["acars"]["msg_text"] for line in f}
    assert want and want <= {it.message for it in items}


@pytest.mark.parametrize("cfo,snr", [(0.0, 40.0), (-300.0, 12.0)])
def test_c_channel_round_trip_same_voice_as_jax(cfo, snr):
    """The tests/test_c_channel.py modem round trip: the port's
    demodulator and C framer give the JAX chain's voice frames and
    signalling, and every transmitted frame."""
    rng = np.random.default_rng(2)
    frames = c_frames(rng)
    bits = build_c_frames(frames, lead_frames=3)
    sig = jo.oqpsk_modulate(bits, 48000, 8400, freq=8000.0 + cfo)
    p = np.mean(sig ** 2)
    noisy = (sig + rng.normal(0, np.sqrt(p / 10 ** (snr / 10)), len(sig))
             ).astype(np.float32)
    x = np.concatenate([noisy, np.zeros(48000, np.float32)])
    res = []
    for demod, framer in ((jo.OqpskDemodulator, JCFramer),
                          (functools.partial(to.OqpskDemodulator,
                                             device="cpu"), TCFramer)):
        outs = demod(48000, 8400).process(x)
        soft = np.concatenate([o["soft_bits"] for o in outs]).astype(
            np.float32)
        evs = framer().feed(soft)
        res.append([(e.voice, [(bytes(s), ok) for s, ok, _ in e.signalling])
                    for e in evs])
    assert res[1] == res[0]
    voices = [v for v, _ in res[1]]
    assert all(f[1] in voices for f in frames)
