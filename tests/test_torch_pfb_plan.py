"""The fused station's filterbank plans (``FusedStation(pfb_oversample=)``).

The 2x plan (the default, JAX's): K = 2 fs / channel rate, hop K/2.  The
4x plan: K = 4 fs / channel rate, hop K/4, the same channel rate, block
and packed layout, a prototype that passes a VFO anywhere in its bin with
its band, and residual mixes that start at the filterbank's delay.

1. The 4-parity fold equals the plain (unfold) form; the 4x prototype
   meets its design.
2. ``pfb_oversample=2`` is the parent's step byte for byte (held to the
   benchmark's frozen copy of it, ``aerobench/ref/step.py``); any plan but
   2 and 4 is refused, by the station and by ``station_main``.
3. A C-band bank at 1.536 MS/s with P and C VFOs 1, 5 and 11 kHz from a
   24 kHz bin's centre, under noise: the 4x plan gets every planted ACARS
   message and voice frame out.  The 2x plan loses the 5 kHz pair: a
   signal carried on both sides of its VFO, as the benchmark's traffic
   carries it, leaves that plan's channel with its carrier turned by
   2 pi d (L/2 - M) / fs, and the station's real audio keeps the cosine of
   that angle of its amplitude: 0.61, 0.13 and 0.79 at d = 1, 5, 11 kHz.
4. A checkpoint round trip on the 4x plan resumes bit for bit, and a
   checkpoint of the other plan is refused; the sharded station takes the
   plan.
"""

import numpy as np
import pytest
import torch

from aero_tpu_torch.channelizer import load_ini, pfb
from aero_tpu_torch.runtime import station_main
from aero_tpu_torch.runtime.fused_station import FusedStation
from tests.test_torch_cuda import cband_ini

torch.set_num_threads(2)

FS = 1536000


@pytest.mark.parametrize("K", [128, 24])
def test_four_parity_fold_equals_the_plain_form(K):
    rng = np.random.default_rng(K)
    M = K // 4
    T = M * 64
    sa = sb = pfb.pfb_init(K, oversample=4)
    assert sa.shape == (8 * K - M,)
    for _ in range(3):
        x = torch.from_numpy((rng.standard_normal(T)
                              + 1j * rng.standard_normal(T)
                              ).astype(np.complex64))
        sa, za = pfb.pfb_channelize(sa, x, K, oversample=4)
        sb, zb = pfb.pfb_channelize_fused(sb, x, K, oversample=4)
        assert za.shape == zb.shape == (K, T // M)
        peak = float(za.abs().max())
        assert float((za - zb).abs().max()) <= 2e-6 * peak
        assert torch.equal(sa, sb)


def test_the_4x_prototype_meets_its_design():
    K = 128
    h = pfb.pfb_prototype_os4(K).astype(np.float64)
    assert h.shape == (8 * K,) and h[-1] == 0.0
    assert np.sum(h) == pytest.approx(K / 2, rel=1e-6)     # gain 2M
    H = np.abs(np.fft.fft(h, 1 << 17)) / (K / 2)
    f = np.abs(np.fft.fftfreq(1 << 17)) * K                 # in bins
    assert np.max(np.abs(20 * np.log10(H[f <= 1.525]))) < 1e-3
    assert 20 * np.log10(np.max(H[f >= 2.475])) < -95.0


def test_a_tone_leaves_either_plan_at_its_residual_with_one_gain():
    n = np.arange(32 * 4000)
    for f in (49000.0, 101000.0, -155000.0):
        x = torch.from_numpy((0.1 * np.exp(2j * np.pi * f * n / FS)
                              ).astype(np.complex64))
        for o in (2, 4):
            K, M = pfb.pfb_plan(FS, 48000, o)
            k = pfb.pfb_bin_for_freq(f, FS, K)
            d = f - (k if k < K // 2 else k - K) * FS / K
            _, z = pfb.pfb_channelize_fused(pfb.pfb_init(K, oversample=o),
                                            x, K, oversample=o)
            m = np.arange(200, len(n) // M)
            r = z[k].numpy()[200:] / np.exp(2j * np.pi * d * m * M / FS)
            # the 2x prototype's ripple: +0.03 dB at 11 kHz from the centre
            assert np.abs(r).mean() == pytest.approx(6.4, rel=4e-3), (f, o)
            assert np.std(np.angle(r)) < 1e-5


def test_the_4x_plan_low_passes_only_its_oqpsk_watchers():
    from aero_tpu_torch.runtime.fused_station import _watcher_taps
    h = _watcher_taps(48000.0, 32, torch.device("cpu"))[0, 0].double()
    h = h.numpy()
    assert h.shape == (63,) and np.allclose(h, h[::-1])
    # DC gain 1/(2M): the channel gain of the filterbank undone
    assert np.sum(h) == pytest.approx(1 / 64, rel=1e-5)
    H = np.abs(np.fft.rfft(h * 64, 1 << 15))
    f = np.fft.rfftfreq(1 << 15, 1 / 48000)
    assert np.max(np.abs(20 * np.log10(H[f <= 13250]))) < 2e-3
    assert 20 * np.log10(np.max(H[f >= 17500])) < -75.0
    cfg = _small_cband()
    for plan, want in ((2, False), (4, True)):
        st = FusedStation(cfg, pfb_oversample=plan, device="cpu")
        g = st._init_state()["grp"]
        assert ("chan" in g[(48000, 10500, True)]) is want
        assert all("chan" not in g[k] for k in g if not k[2])


def _bank_ini(fs=288000):
    return (f"[General]\nsample_rate={fs}\ncenter_frequency=1545000000\n"
            "[vfos]\nsize=3\n"
            "1\\frequency=1545019000\n1\\data_rate=1200\n1\\topic=V1\n"
            "2\\frequency=1545061000\n2\\data_rate=10500\n2\\topic=P2\n"
            "3\\frequency=1544950000\n3\\data_rate=1200\n3\\topic=R3\n"
            "3\\burst=1\n")


def test_the_default_plan_is_the_parents_step_byte_for_byte():
    from aerobench.ref.step import RefStation
    cfg = load_ini(_bank_ini(), is_text=True)
    default = FusedStation(cfg, ingest_dtype="int4", device="cpu")
    two = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=2,
                       device="cpu")
    ref = RefStation([("V1", 19000, 1200, False), ("P2", 61000, 10500, False),
                      ("R3", -50000, 1200, True)], 288000, "int4",
                     device="cpu")
    assert default.pfb_oversample == 2 and default._K == two._K == ref.K
    rng = np.random.default_rng(2)
    L = default.block_len
    s_d, s_t, s_r = default._init_state(), two._init_state(), ref.init_state()
    for _ in range(3):
        x = (0.2 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
             ).astype(np.complex64)
        q = torch.from_numpy(default.quantize(x))
        s_d, p_d = default._step(s_d, q, torch.tensor(1.0))
        s_t, p_t = two._step(s_t, q, torch.tensor(1.0))
        s_r, p_r = ref.step(s_r, x)
        assert np.array_equal(p_d.numpy(), p_t.numpy())
        assert np.array_equal(p_d.numpy(), p_r.numpy())


@pytest.mark.parametrize("plan", [0, 1, 3, 8])
def test_a_plan_other_than_2_or_4_is_refused(plan):
    with pytest.raises(ValueError, match="pfb_oversample"):
        FusedStation(load_ini(_bank_ini(), is_text=True),
                     pfb_oversample=plan, device="cpu")


@pytest.mark.parametrize("argv", [["--pfb-oversample", "3"],
                                  ["--pfb-oversample", "4",
                                   "--backend", "tree"]])
def test_station_main_refuses_a_plan_it_cannot_build(tmp_path, argv):
    ini = tmp_path / "bank.ini"
    ini.write_text(_bank_ini())
    with pytest.raises(SystemExit):
        station_main.main(["-c", str(ini), "--device", "cpu"] + argv)


def test_the_4x_plan_keeps_the_block_and_layout_and_moves_the_bins():
    cfg = load_ini(_bank_ini(FS), is_text=True)
    two = FusedStation(cfg, pfb_oversample=2, device="cpu")
    four = FusedStation(cfg, pfb_oversample=4, device="cpu")
    assert two._K == {24000: 128, 48000: 64}
    assert four._K == {24000: 256, 48000: 128}
    assert four._M == two._M and four.block_len == two.block_len
    assert four._packed_len == two._packed_len
    assert four._soft_ofs == two._soft_ofs
    st = four._init_state()
    assert st["pfb"][48000].shape == (8 * 128 - 32,)
    # every residual within half a 12 kHz bin; each mix starts at the
    # filterbank's delay, 480 input samples at K = 128
    key = (48000, 10500, False)
    bins, resid = four._params[key]
    assert int(bins[0]) == 5 and float(resid[0]) * 48000 == pytest.approx(
        -1000.0)
    assert float(st["grp"][key]["phase"][0]) == pytest.approx(
        (1000.0 * 480 / FS) % 1.0)
    assert pfb.pfb_delay(128, 4) == 480 and pfb.pfb_delay(64, 2) == 224
    assert not two._init_state()["grp"][key]["phase"].any()


# ---- a C-band bank at 1.536 MS/s, VFOs 1, 5 and 11 kHz off 24 kHz bins ----

OFFSETS = (1, 5, 11)
N_MSG = 4           # ACARS messages per P VFO, each followed by a fill frame
N_VOICE = 6         # voice frames per C VFO
BLOCKS = 18         # 6 s


def _layout():
    out = []
    for j, d in enumerate(OFFSETS):
        out.append((f"P{d:02d}", 96000 * (1 + j) + 1000 * d, 10500, False))
        out.append((f"C{d:02d}", -96000 * (1 + j) - 1000 * d, 8400, False))
    return out


@pytest.fixture(scope="module")
def cband_capture():
    """(layout, wideband IQ, {P topic: texts}, {C topic: voice frames}):
    each VFO's real OQPSK audio at 8 kHz (amplitude 0.2) put at its
    offset in one inverse FFT, and complex noise 0.15 on the band."""
    from aero_tpu_torch.models.oqpsk import oqpsk_modulate
    from aero_tpu_torch.protocol.c_framing import build_c_frames
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    from aero_tpu_torch.protocol.framing import FRAME_SPECS, build_p_frames
    from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
    layout = _layout()
    n = BLOCKS * 512000
    n48 = n // 32
    rng = np.random.default_rng(11)
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    per = FRAME_SPECS[10500].payload_info_bits // 96
    spec = np.zeros(n, np.complex128)
    f48 = np.fft.fftfreq(n48, 1 / 48000)
    texts, voices = {}, {}
    for k, (topic, off, rate, _) in enumerate(layout):
        if rate == 10500:
            texts[topic] = [f"{topic} PLAN TEST {i}" for i in range(N_MSG)]
            fields = []
            for i, t in enumerate(texts[topic]):
                sus = [append_crc16_bytes(b) for b in segment_isu(
                    make_acars_userdata("2", f"N{k}{i:03d}", "!", "H1", "A",
                                        t), 0x500000 + k, 0x41)]
                sus += [fill] * (per - len(sus))
                fields += [b"".join(sus), fill * per]
            fields += [fill * per] * 4
            audio = oqpsk_modulate(build_p_frames(fields, 10500, 2), 48000,
                                   10500.0, amplitude=0.2)
        else:
            frames = [([append_crc16_bytes(bytes([0x30]) + bytes(
                rng.integers(0, 256, 9).tolist())) for _ in range(3)],
                bytes(rng.integers(0, 256, 300).tolist()))
                for _ in range(N_VOICE + 3)]
            voices[topic] = [v for _, v in frames[:N_VOICE]]
            audio = oqpsk_modulate(build_c_frames(frames, lead_frames=2),
                                   48000, 8400.0, amplitude=0.2)
        a = np.zeros(n48)
        a[:min(n48, len(audio))] = audio[:n48]
        idx = np.round((f48 + off) * n / FS).astype(np.int64) % n
        spec[idx] += np.fft.fft(a) * 32
    wide = np.fft.ifft(spec) + 0.15 * (rng.standard_normal(n)
                                       + 1j * rng.standard_normal(n))
    return layout, wide.astype(np.complex64), texts, voices


def _run(capture, plan):
    """(texts out by P topic, voice frames out by C topic)."""
    layout, wide, _, _ = capture
    msgs, voice = {}, {}
    st = FusedStation(
        load_ini(cband_ini(FS, layout), is_text=True), ingest_dtype="int4",
        pfb_oversample=plan, device="cpu",
        on_acars=lambda v, it: msgs.setdefault(v, set()).add(it.message),
        on_voice=lambda v, d, h: voice.setdefault(v, set()).add(bytes(d)))
    L = st.block_len
    for b in range(BLOCKS):
        st.process(wide[b * L:(b + 1) * L])
    st.flush()
    return msgs, voice


def _lost(capture, out):
    _, _, texts, voices = capture
    msgs, voice = out
    lost = {t: sum(x not in msgs.get(t, ()) for x in want)
            for t, want in texts.items()}
    lost.update({t: sum(v not in voice.get(t, ()) for v in want)
                 for t, want in voices.items()})
    return lost


def test_the_4x_plan_gets_every_message_and_voice_frame(cband_capture):
    lost = _lost(cband_capture, _run(cband_capture, 4))
    assert lost == {t: 0 for t in lost}, lost


def test_the_2x_plan_loses_the_vfo_whose_carrier_it_turns(cband_capture):
    lost = _lost(cband_capture, _run(cband_capture, 2))
    # cos(2 pi d 224 / fs): 0.61, -0.13, -0.79 at d = 1, 5, 11 kHz
    assert lost["P05"] == N_MSG and lost["C05"] == N_VOICE, lost
    assert lost["P01"] == lost["P11"] == 0, lost
    assert lost["C01"] == lost["C11"] == 0, lost


# ---- checkpoints and shards on the 4x plan ----

def _small_cband(fs=288000):
    layout = [("P00", -95000, 10500, False), ("P01", -63000, 10500, False),
              ("C02", 1000, 8400, False), ("C03", 33000, 8400, False),
              ("T04", 65000, 10500, True), ("T05", 97000, 10500, True)]
    return load_ini(cband_ini(fs, layout), is_text=True)


def _noise_blocks(st, n, seed=5):
    rng = np.random.default_rng(seed)
    L = st.block_len
    return [(0.2 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
             ).astype(np.complex64) for _ in range(n)]


def test_a_checkpoint_on_the_4x_plan_resumes_bit_for_bit(tmp_path):
    cfg = _small_cband()
    a = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                     device="cpu")
    blocks = _noise_blocks(a, 5)
    for x in blocks[:3]:
        a.process(x)
    path = str(tmp_path / "os4.ckpt")
    a.save_checkpoint(path)
    with np.load(path) as z:
        assert int(z["meta_pfb_oversample"]) == 4
    b = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                     device="cpu")
    b.load_checkpoint(path)
    for st in (a, b):
        st._tail = []
        st._drain_orig = st._drain
        st._drain = (lambda s: lambda p: (s._tail.append(p.cpu().numpy()),
                                          s._drain_orig(p)))(st)
        for x in blocks[3:]:
            st.process(x)
        st.flush()
    assert len(a._tail) == len(b._tail) == 2
    for pa, pb in zip(a._tail, b._tail):
        assert np.array_equal(pa, pb)


def test_a_checkpoint_of_the_other_plan_is_refused(tmp_path):
    cfg = _small_cband()
    for save, load in ((2, 4), (4, 2)):
        path = str(tmp_path / f"plan{save}.ckpt")
        FusedStation(cfg, pfb_oversample=save,
                     device="cpu").save_checkpoint(path)
        with pytest.raises(ValueError, match="filterbank plan "
                           f"pfb_oversample={save} != station {load}"):
            FusedStation(cfg, pfb_oversample=load,
                         device="cpu").load_checkpoint(path)


def test_the_sharded_station_takes_the_plan():
    """Over 2 CPU shards (two or more rows of each group a shard), within
    tests/test_torch_parallel.py's limits for a sharded station: soft
    bytes within +-1 on >= 99.9%, telemetry to 1e-4."""
    from aero_tpu_torch.parallel.mesh import make_mesh
    layout = [(f"{k}{i:02d}", -117000 + 26000 * i, rate, k == "T")
              for i, (k, rate) in enumerate([("P", 10500)] * 4
                                            + [("C", 8400)] * 4
                                            + [("T", 10500)] * 2)]
    cfg = load_ini(cband_ini(288000, layout), is_text=True)
    one = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                       device="cpu")
    two = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                       device="cpu").shard(make_mesh(2, device="cpu"))
    assert [len(s["grp"][(48000, 10500, False)]["phase"])
            for s in two._shards] == [2, 2]
    for st in (one, two):
        st._rows = []
        st._drain_orig = st._drain
        st._drain = (lambda s: lambda p: (s._rows.append(p.cpu().numpy()),
                                          s._drain_orig(p)))(st)
    for x in _noise_blocks(one, 3):
        one.process(x)
        two.process(x)
    one.flush()
    two.flush()
    assert len(one._rows) == len(two._rows) == 3
    n = one._soft_total
    for a, b in zip(one._rows, two._rows):
        a, b = a[0], b[0]
        d = np.abs(a[:n].astype(int) - b[:n].astype(int))
        assert (d > 1).mean() <= 0.001
        np.testing.assert_allclose(b[n:].view(np.float32),
                                   a[n:].view(np.float32), rtol=1e-4,
                                   atol=1e-4)
    assert two._state["pfb"][48000].shape == (8 * 24 - 6,)
    assert torch.equal(two._state["grp"][(48000, 10500, True)]["phase"],
                       one._state["grp"][(48000, 10500, True)]["phase"])
