"""Port parity for the slice as a whole: the fused station on the mixed
INI of tests/test_fused_mixed.py, every VFO kind in one station.

Ten VFOs at 288 kS/s, two per kind: MSK 600 and 1200 and OQPSK 10500 P
channels, OQPSK 8400 C channels and burst MSK 600 R/T watchers; content on
one VFO of each kind (ACARS on the P channels, two frames of known voice
and signalling on the C channel, one T burst carrying ACARS).

1. Free-running on the CPU, the port's ``FusedStation`` gives the JAX
   station's ACARS, voice frames, burst windows and packets, frame and SU
   counts exactly, and its last telemetry to float32 error.
2. One step, teacher-forced from the JAX state through ``convert``, gives
   the same packed buffer within the limits of
   tests/test_torch_cuda.py:check_packed: on continuous groups soft bytes
   within +-1 on >= 99.9% and equal on >= 99% of the bytes, lock flags and
   slips exact, mse 1e-4 relative, freq 2e-3 Hz (the limits of
   tests/test_torch_oqpsk.py), Eb/N0 1e-3 dB or 1e-4 relative (its
   argument var*a^2 - 0.0085 cancels at high SNR, so a float32 error in
   the envelope's variance grows there: 28 dB on the clean 10500 VFO);
   on burst groups the int16 audio within one LSB and its RMS and peak to
   1e-4 relative.  The state carried back
   out runs in the JAX station to a bit-identical buffer, and the port's
   ``vfo_spectrum`` on the carried state equals the JAX station's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.models.msk import msk_modulate
from aero_tpu.models.oqpsk import oqpsk_modulate
from aero_tpu.protocol.c_framing import build_c_frames
from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu.protocol.rt_framing import build_t_burst
from aero_tpu.runtime.fused_station import FusedStation as JaxStation
from aero_tpu_torch import convert
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.runtime.fused_station import FusedStation
from tests.test_fused_mixed import (CENTER, FS, MIXED_TOPICS, _p_stream,
                                    _to_wideband)
from tests.test_torch_cuda import check_packed

torch.set_num_threads(2)

INI = (f"[General]\nsample_rate={FS}\ncenter_frequency={CENTER}\n"
       "[vfos]\nsize=10\n"
       f"1\\frequency={CENTER + 6000}\n1\\data_rate=600\n1\\topic=M600\n"
       f"2\\frequency={CENTER + 24000}\n2\\data_rate=1200\n2\\topic=M1200\n"
       f"3\\frequency={CENTER + 48000}\n3\\data_rate=10500\n3\\topic=Q10500\n"
       f"4\\frequency={CENTER + 96000}\n4\\data_rate=8400\n4\\topic=C8400\n"
       f"5\\frequency={CENTER - 30000}\n5\\data_rate=600\n5\\topic=BURST\n"
       "5\\burst=1\n"
       f"6\\frequency={CENTER - 12000}\n6\\data_rate=600\n6\\topic=M600b\n"
       f"7\\frequency={CENTER - 72000}\n7\\data_rate=1200\n7\\topic=M1200b\n"
       f"8\\frequency={CENTER - 110000}\n8\\data_rate=10500\n"
       "8\\topic=Q10500b\n"
       f"9\\frequency={CENTER - 96000}\n9\\data_rate=8400\n9\\topic=C8400b\n"
       f"10\\frequency={CENTER + 72000}\n10\\data_rate=600\n"
       "10\\topic=BURSTb\n10\\burst=1\n")


def _wideband():
    """The signal of tests/test_fused_mixed.py's fixture (same seed)."""
    rng = np.random.default_rng(7)
    cframes = []
    for _ in range(2):
        csus = [append_crc16_bytes(
            bytes([0x30]) + bytes(rng.integers(0, 256, 9,
                                               dtype=np.uint8).tolist()))
            for _ in range(3)]
        voice = bytes(rng.integers(0, 256, 300, dtype=np.uint8).tolist())
        cframes.append((csus, voice))
    bsus = segment_isu(make_acars_userdata("2", "NBURST", "!", "H1", "A",
                                           "MIX BURST"), 0x444444, 0x41)
    bt = build_t_burst(0x444444, 0x41, bsus, preamble_bits=96)
    dur = 9 * FS
    wb = np.zeros(dur, np.complex64)
    wb += _to_wideband(msk_modulate(_p_stream(600, "MIX 600", 2),
                                    12000, 600.0, freq=1000.0),
                       12000, 6000, dur // 24)
    wb += _to_wideband(msk_modulate(_p_stream(1200, "MIX 1200", 3),
                                    24000, 1200.0, freq=1000.0),
                       24000, 24000, dur // 12)
    wb += _to_wideband(oqpsk_modulate(_p_stream(10500, "MIX 10500", 6),
                                      48000, 10500.0, freq=8000.0),
                       48000, 48000, dur // 6)
    wb += _to_wideband(oqpsk_modulate(build_c_frames(cframes, lead_frames=3),
                                      48000, 8400, freq=8000.0),
                       48000, 96000, dur // 6)
    burst_audio = np.concatenate(
        [np.zeros(2 * 12000, np.float32),
         msk_modulate(bt, 12000, 600.0, freq=3000.0) * 1.6])
    wb += _to_wideband(burst_audio, 12000, -30000, dur // 24)
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)
    return wb, cframes


@pytest.fixture(scope="module")
def wideband():
    return _wideband()


def _run(cls, wb, **kw):
    got, voices = [], []
    st = cls(load_ini(INI, is_text=True), ingest_dtype="int16",
             on_acars=lambda t, item: got.append((t, item.message)),
             on_voice=lambda t, data, hx: voices.append((t, data)), **kw)
    w = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
    for i in range(0, (len(w) // st.block_len) * st.block_len, st.block_len):
        st.process(w[i:i + st.block_len])
    st.flush()
    s = st.stats
    counts = (s.frames, s.su_ok, s.su_bad, s.acars, s.voice_frames,
              s.burst_windows, s.burst_packets)
    return sorted(got), sorted(voices), counts, st


def test_mixed_station_same_as_jax(wideband):
    wb, cframes = wideband
    jgot, jvoices, jcounts, jst = _run(JaxStation, wb)
    tgot, tvoices, tcounts, tst = _run(FusedStation, wb, device="cpu")
    assert tgot == jgot and tvoices == jvoices and tcounts == jcounts
    for want in (("M600", "MIX 600"), ("M1200", "MIX 1200"),
                 ("Q10500", "MIX 10500"), ("BURST", "MIX BURST")):
        assert want in tgot
    cv = [v for t, v in tvoices if t == "C8400"]
    assert all(voice in cv for _, voice in cframes)
    assert tst.stats.burst_packets >= 1
    np.testing.assert_allclose(tst.telemetry, np.asarray(jst.telemetry),
                               rtol=1e-3, atol=1e-3)
    tel = tst.vfo_telemetry()
    assert set(tel) == MIXED_TOPICS
    assert tel["BURST"]["packets"] >= 1 and tel["BURST"]["signal"]
    assert abs(tel["BURST"]["freq"] - 3000.0) < 200.0
    assert all(t.device.type == "cpu" for t in tst._state["pfb"].values())


def test_mixed_step_teacher_forced(wideband):
    wb, _ = wideband
    cfg = load_ini(INI, is_text=True)
    jst = JaxStation(cfg, ingest_dtype="int16")
    tst = FusedStation(cfg, ingest_dtype="int16", device="cpu")
    assert tst._soft_total == jst._soft_total
    assert tst._soft_ofs == jst._soft_ofs and tst._tel_ofs == jst._tel_ofs
    step = jst._get_step(1)
    L = jst.block_len
    locked = 0
    for b in range(5):
        arr = jst.quantize(wb[b * L:(b + 1) * L])
        jnew, jpacked = step(jst._state, jnp.asarray(arr[None]),
                             jnp.asarray([1.0], jnp.float32))
        jpacked = np.asarray(jpacked)[0]
        if b >= 3:
            jstate = jax.tree.map(np.asarray, jst._state)
            tstate = convert.fused_state_from_numpy(jstate)
            assert set(tstate["grp"]) == set(jstate["grp"])
            tnew, tpacked = tst._step(tstate, torch.from_numpy(arr),
                                      torch.tensor(np.float32(1.0)))
            assert tpacked.dtype == torch.uint8
            assert tpacked.shape == jpacked.shape
            check_packed(tst, tpacked.numpy(), jpacked)
            # the carried state goes back into JAX losslessly
            back = jax.tree.map(jnp.asarray,
                                convert.fused_state_to_numpy(tstate))
            _, jpacked2 = step(back, jnp.asarray(arr[None]),
                               jnp.asarray([1.0], jnp.float32))
            np.testing.assert_array_equal(np.asarray(jpacked2)[0], jpacked)
            # vfo_spectrum reads the same carry in both stations
            tst._state = tstate
            for topic in ("M600", "Q10500", "C8400"):
                jf, jdb = jst.vfo_spectrum(topic)
                tf, tdb = tst.vfo_spectrum(topic)
                np.testing.assert_array_equal(tf, jf)
                np.testing.assert_array_equal(tdb, jdb)
            assert tst.vfo_spectrum("BURST") is None
            tel = jpacked[jst._soft_total:].view(np.float32)
            for key in jst._order:
                if not key[2]:
                    o, nb = jst._tel_ofs[key], len(jst.groups[key])
                    locked += int(tel[o: o + nb].sum())
        jst._state = jnew
    assert locked > 0, "the forced blocks never saw a locked VFO"


def test_convert_round_trips_oqpsk_and_burst_groups():
    """JAX tree -> port -> JAX tree, and port -> JAX -> port, leaf for
    leaf, on a station with OQPSK 10500/8400 and burst groups."""
    cfg = load_ini(INI, is_text=True)
    jst = JaxStation(cfg, ingest_dtype="int16")
    jtree = jax.tree.map(np.asarray, jst._state)
    port = convert.fused_state_from_numpy(jtree)
    for key, g in port["grp"].items():
        if key[2]:
            assert set(g) == {"phase"}
        else:
            want = convert.DEMOD_STATE[key[1]]
            assert type(g["demod"]) is want
    back = convert.fused_state_to_numpy(port)
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # and the port's own initial state round-trips through the JAX layout
    tst = FusedStation(cfg, ingest_dtype="int16", device="cpu")
    again = convert.fused_state_from_numpy(
        convert.fused_state_to_numpy(tst._state))
    for key, g in tst._state["grp"].items():
        for name, v in g.items():
            w = again["grp"][key][name]
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, w)
            elif isinstance(v, dict):
                assert all(torch.equal(v[k], w[k]) for k in v)
            else:
                assert all(torch.equal(a, b) for a, b in zip(v, w))
