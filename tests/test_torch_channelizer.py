"""Port parity for the classic channelizers: ``aero_tpu_torch.ops.fir``'s
decimating filters, ``channelizer.Channelizer`` and ``pfb.PfbChannelizer``
against JAX on the CPU, over several blocks (the carries must agree across
block boundaries).

Tolerances: the filters are float32 convolutions in another summation
order than XLA's, so float outputs agree to 1e-5 relative to the block's
peak; the int16 audio payloads (gain * 32768 then a truncating cast, at
~15000 LSB where a float32 ulp is ~1e-3 LSB) within one LSB, off by one
on at most 1% of a payload's samples (0.05-0.5% seen); the 4-bit main-VFO
nibbles
(top nibble of each int8 arm) equal on all but 0.2% of the bytes; the
DC-tracker carry to float32 rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aero_tpu.channelizer import Channelizer as JaxChannelizer, load_ini
from aero_tpu.channelizer.pfb import (PfbChannelizer as JaxPfb,
                                      pfb_extract_vfo as jax_extract)
from aero_tpu.ops import fir as jfir
from aero_tpu.ops.design import HALFBAND_TAPS, low_pass_design
from aero_tpu_torch.channelizer.channelizer import Channelizer
from aero_tpu_torch.channelizer.pfb import PfbChannelizer, pfb_extract_vfo
from aero_tpu_torch.ops import fir as tfir
from aero_tpu_torch.ops.spectral import single_bin_dft, tone_phase_and_freq
from tests.torch_natives import ingest  # noqa: F401

torch.set_num_threads(2)

# one main (1.536 MS/s -> 192 kS/s, decim 3) with 600 and 1200 subs under
# it (one with a post filter), and a 1200 burst sub taken straight from
# the wideband (decim 6); DC correction on
INI_TREE = """
[General]
sample_rate=1536000
center_frequency=1545200000
correct_dc_bias=1
[main_vfos]
size=1
1\\frequency=1545150000
1\\out_rate=192000
1\\zmq_topic=WB54
1\\compress_scale=1
[vfos]
size=4
1\\frequency=1545095000
1\\data_rate=600
1\\topic=A600
1\\gain=100
2\\frequency=1545120000
2\\data_rate=1200
2\\topic=B1200
2\\gain=100
3\\frequency=1545130000
3\\data_rate=1200
3\\topic=C1200
3\\gain=100
3\\filter_bandwidth=3000
4\\frequency=1545390000
4\\data_rate=1200
4\\topic=RCH01
4\\burst=1
4\\gain=100
"""

# 288 kS/s: the subs take the x6 late decimate (publisher.cpp:202)
INI_LATE = """
[General]
sample_rate=288000
center_frequency=1545000000
[vfos]
size=2
1\\frequency=1545009000
1\\data_rate=1200
1\\topic=L1
1\\gain=100
2\\frequency=1544980000
2\\data_rate=600
2\\topic=L2
2\\gain=100
"""


def _wide(n, seed):
    rng = np.random.default_rng(seed)
    return (0.2 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            + 0.05 + 0.02j).astype(np.complex64)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_decimate_delay_halfband_carry(cplx):
    """Three blocks of odd lengths (each a multiple of the factor): the
    outputs and carries equal JAX's, block by block."""
    rng = np.random.default_rng(3)
    taps = low_pass_design(2.0, 24000 * 5, 12000, 24000 / 4).astype(
        np.float32)
    hb = HALFBAND_TAPS[11].astype(np.float32)
    dt = np.complex64 if cplx else np.float32
    jd, td = jnp.complex64 if cplx else jnp.float32, (
        torch.complex64 if cplx else torch.float32)
    js = (jfir.fir_decimate_init(len(taps), (2,), jd),
          jfir.delay_init(7, (2,), jd),
          jfir.halfband_cascade_init(2, len(hb), (2,), jd))
    ts = (tfir.fir_decimate_init(len(taps), (2,), td),
          tfir.delay_init(7, (2,), td),
          tfir.halfband_cascade_init(2, len(hb), (2,), td))
    for T in (45, 135, 75):
        x = rng.standard_normal((2, T)).astype(np.float32)
        if cplx:
            x = (x + 1j * rng.standard_normal((2, T))).astype(dt)
        jdec, jy = jfir.fir_decimate_apply(js[0], jnp.asarray(x), taps, 5)
        tdec, ty = tfir.fir_decimate_apply(ts[0], torch.from_numpy(x), taps, 5)
        _close(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
        jdl, jz = jfir.delay_apply(js[1], jnp.asarray(x))
        tdl, tz = tfir.delay_apply(ts[1], torch.from_numpy(x))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(tdl.numpy(), np.asarray(jdl))
        xe = x[:, : T - T % 4]
        jhs, jh = jfir.halfband_cascade_apply(js[2], jnp.asarray(xe), hb)
        ths, th = tfir.halfband_cascade_apply(ts[2], torch.from_numpy(xe), hb)
        _close(th.numpy(), np.asarray(jh))
        for a, b in zip(ths, jhs):
            _close(a.numpy(), np.asarray(b))
        js, ts = (jdec, jdl, jhs), (tdec, tdl, ths)
    with pytest.raises(ValueError):
        tfir.fir_decimate_apply(ts[0], torch.zeros(2, 7, dtype=td), taps, 5)


def test_spectral_helpers_match_jax():
    from aero_tpu.ops import spectral as js
    rng = np.random.default_rng(5)
    n = np.arange(4000)
    x = (np.exp(2j * np.pi * 0.1234 * n)[None] * np.array([[1.0], [0.5]])
         + 0.1 * rng.standard_normal((2, 4000))).astype(np.complex64)
    f = np.array([0.1233, 0.1236], np.float32)
    _close(single_bin_dft(torch.from_numpy(x), torch.from_numpy(f)).numpy(),
           np.asarray(js.single_bin_dft(jnp.asarray(x), jnp.asarray(f))),
           rel=1e-4)
    got = tone_phase_and_freq(torch.from_numpy(x), torch.from_numpy(f), 2)
    want = js.tone_phase_and_freq(jnp.asarray(x), jnp.asarray(f), 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


def _payload_diffs(got, want):
    """Fraction of int16 samples off by one, and the largest difference."""
    g = np.frombuffer(got, "<i2").astype(np.int32)
    w = np.frombuffer(want, "<i2").astype(np.int32)
    assert g.shape == w.shape
    d = np.abs(g - w)
    return float((d > 0).mean()) if len(d) else 0.0, int(d.max(initial=0))


def _check_outputs(got, want):
    assert [(t, r) for t, r, _ in got] == [(t, r) for t, r, _ in want]
    for (topic, _, g), (_, _, w) in zip(got, want):
        if topic.startswith("WB"):
            g, w = np.frombuffer(g, np.uint8), np.frombuffer(w, np.uint8)
            assert g.shape == w.shape
            assert float((g != w).mean()) <= 0.002, topic
        else:
            frac, worst = _payload_diffs(g, w)
            assert worst <= 1 and frac <= 0.01, (topic, frac, worst)


def channelizer_parity(ini, blocks):
    """Run both channelizers on the same blocks and hold every output and
    the DC-tracker carry to the tolerances above."""
    cfg = load_ini(ini, is_text=True)
    jch = JaxChannelizer(cfg)
    tch = Channelizer(cfg, device="cpu")
    for b, T in enumerate(blocks):
        iq = _wide(T, b) * (4.0 if cfg.sample_rate == 1536000 else 1.0)
        got, want = tch.process(iq), jch.process(iq)
        _check_outputs(got, want)
        assert any(len(p) for _, _, p in got)
        np.testing.assert_allclose(tch._dc_state, jch._dc_state,
                                   rtol=1e-5, atol=1e-9)
    if cfg.correct_dc_bias:
        assert np.abs(tch._dc_state).max() > 0


# (station file, block lengths) of the channelizer parity streams
STREAMS = {"tree_1536k": (INI_TREE, (38400, 76800, 25600)),
           "late_288k": (INI_LATE, (43200, 28800, 57600))}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_channelizer_matches_jax(ingest, stream):
    """On the native ingest path and on the numpy one, both packages on
    the same one (tests/torch_natives.py)."""
    channelizer_parity(*STREAMS[stream])


def test_pfb_channelizer_matches_jax():
    """The 50-VFO style bank at 1.536 MS/s: an even hop count per block
    (the fused fold) and an odd one (the gather form)."""
    vfos = "".join(
        f"{i + 1}\\frequency={1545002000 + i * 19000}\n"
        f"{i + 1}\\data_rate=1200\n{i + 1}\\topic=V{i}\n" for i in range(5))
    cfg = load_ini("[General]\nsample_rate=1536000\n"
                   "center_frequency=1545000000\n[vfos]\nsize=5\n" + vfos,
                   is_text=True)
    jch, tch = JaxPfb(cfg), PfbChannelizer(cfg, device="cpu")
    for b, T in enumerate((64 * 250, 64 * 251, 64 * 100)):
        _check_outputs(tch.process(_wide(T, b)), jch.process(_wide(T, b)))
        for r in tch._state:
            _close(tch._state[r].numpy(), np.asarray(jch._state[r][0])
                   + 1j * np.asarray(jch._state[r][1]))
            np.testing.assert_allclose(tch._phase[r].numpy(),
                                       np.asarray(jch._phase[r]), atol=1e-6)


def test_pfb_asserts_on_main_topics_and_extract_vfo():
    """As in JAX, the PFB backend refuses main-VFO topics (the 54W
    station file has one); ``pfb_extract_vfo`` equals JAX's."""
    cfg = load_ini(INI_TREE, is_text=True)
    with pytest.raises(AssertionError, match="sub-VFO audio only"):
        PfbChannelizer(cfg, device="cpu")
    z = _wide(1000, 9)
    jp, jz = jax_extract(jnp.asarray(z), jnp.float32(0.25), jnp.float32(0.0123),
                         K=128)
    tp, tz = pfb_extract_vfo(torch.from_numpy(z), 0.25, 0.0123)
    _close(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(float(tp), float(jp), atol=1e-6)


def test_channelizer_defaults_to_the_card():
    cfg = load_ini(INI_LATE, is_text=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Channelizer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PfbChannelizer(cfg)
