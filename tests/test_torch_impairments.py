"""The reference's channel-impairment envelopes, free-running on the port.

The 16 scenarios of tests/test_impairments.py (Doppler ramps, sample-clock
offsets, phase noise, the 400 ppm stream through both stations, the fused
station's ramp, the C channel at 100 ppm, all MSK impairments at once and
burst R under them) run through the port's demodulators and stations on
the CPU, on JAX's streams (tests/torch_impair.py builds them on the
port's modulators, sample for sample equal to JAX's), and must meet JAX's
thresholds unchanged.  Nothing is teacher-forced: each run carries its
own state from the first block to the last.

On the three shortest scenarios (MSK phase noise, MSK +100 ppm, the fused
station at 400 ppm) JAX's own chain decodes the same stream, and the port
must recover the same frame indices or messages.
"""

import numpy as np
import pytest
import torch

import torch_impair as ti
from tests import test_impairments as jt

torch.set_num_threads(2)


@pytest.mark.parametrize("name", list(ti.ENVELOPES))
def test_envelope_free_running(name):
    run, sent, need = ti.ENVELOPES[name]
    rec = run("cpu")
    assert len(rec) >= need, (name, len(rec), sent)
    if name in ti.STEADY:
        first, frames, share = ti.STEADY[name]
        steady = [i for i in rec if i >= first]
        assert len(steady) / frames >= share, (name, len(steady), frames)


def test_streams_equal_jax():
    """The port-built streams are JAX's, sample for sample."""
    for build in ("_msk_stream", "_oqpsk_stream"):
        pf, ps = getattr(ti, build)(8)
        jf, js = getattr(jt, build)(8)
        assert pf == jf
        np.testing.assert_array_equal(ps, js)
    pt, pw = ti._wideband_msk_msgs(3, 288000, 24000)
    jt_, jw = jt._wideband_msk_msgs(3, 288000, 24000)
    assert pt == jt_
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(ti._ppm_resample_iq(pw, 400.0),
                                  jt._ppm_resample_iq(jw, 400.0))
    _, sig = ti._msk_stream(4)
    np.testing.assert_array_equal(
        ti.impair(sig, 24000, cfo0=-500.0, ramp=40.0, ppm=60.0, pn=0.003),
        jt.impair(sig, 24000, cfo0=-500.0, ramp=40.0, ppm=60.0, pn=0.003))


@pytest.mark.parametrize("name,ppm,pn", [("msk_phase_noise", 0.0, 0.005),
                                         ("msk_ppm_+100", 100.0, 0.0)])
def test_msk_same_frames_as_jax(name, ppm, pn):
    fields, sig = jt._msk_stream(16 if pn else 28)
    x = jt.impair(sig, 24000, ppm=ppm, pn=pn, seed=9 if pn else 0)
    want = jt._run_msk(fields, x)
    got = ti.ENVELOPES[name][0]("cpu")
    assert got == want, (sorted(set(got) ^ set(want)))


def test_fused_station_400ppm_same_messages_as_jax():
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.fused_station import FusedStation

    texts, wide = jt._wideband_msk_msgs(10, 288000, 24000)
    wide = jt._ppm_resample_iq(wide, 400.0)
    msgs = []
    st = FusedStation(load_ini(ti.SLIP_INI, is_text=True),
                      on_acars=lambda t, it: msgs.append(it.message))
    w = np.concatenate([wide, np.zeros(2 * st.block_len, np.complex64)])
    for i in range(0, (len(w) // st.block_len) * st.block_len, st.block_len):
        st.process(w[i:i + st.block_len])
    st.flush()
    want = [t for t in texts if t in msgs]
    assert ti.fused_ppm("cpu") == want and len(want) >= 9
