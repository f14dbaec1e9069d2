"""The channel-impairment and soak streams of tests/test_impairments.py
and tests/test_soak.py, built on the port, with the scenarios that decode
them free-running on a device.

Each stream is made as JAX's is, on the port's modulators and framers
(copies of the reference's host code) with the same seeds, so every
stream is sample for sample the one JAX's suites decode.  ``ENVELOPES``
lists the 16 impairment scenarios with what each sends and JAX's
threshold for it; a scenario's runner takes a device (``"cpu"`` or
``"cuda"``) and returns what came back: frame indices, or ACARS texts,
voice frames or R-packet kinds.  Every demodulator and station a
scenario builds is appended to the list given as ``built``, so that a
caller can check the device its state lives on.  Shared by
tests/test_torch_impairments.py, tests/test_torch_soak.py and the chip
smoke; imports no JAX.
"""

from __future__ import annotations

import functools
import os

import numpy as np
from scipy.signal import firwin, hilbert, lfilter, resample_poly

from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
from aero_tpu_torch.models.msk import MskDemodulator, msk_modulate
from aero_tpu_torch.models.oqpsk import OqpskDemodulator, oqpsk_modulate
from aero_tpu_torch.ops.viterbi_kernel import stream_decoder
from aero_tpu_torch.protocol.c_framing import build_c_frames
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import (FRAME_SPECS, PChannelFramer,
                                             build_p_frames)
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.protocol.rt_framing import (RTChannelFramer,
                                                build_r_burst, build_t_burst)
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.runtime.station import Station

def _keep(obj, built):
    if built is not None:
        built.append(obj)
    return obj


def impair(sig, fs, cfo0=0.0, ramp=0.0, ppm=0.0, pn=0.0, seed=0):
    """Apply carrier ramp / sample-clock offset / phase noise to real
    audio: analytic signal -> time-varying rotation -> resample."""
    rng = np.random.default_rng(seed)
    z = hilbert(sig.astype(np.float64))
    t = np.arange(len(z)) / fs
    ph = 2 * np.pi * (cfo0 * t + 0.5 * ramp * t * t)
    if pn:
        ph = ph + np.cumsum(rng.normal(0, pn, len(z)))
    x = (z * np.exp(1j * ph)).real
    if ppm:
        r = 1.0 + ppm * 1e-6
        idx = np.arange(int((len(x) - 2) / r)) * r
        x = np.interp(idx, np.arange(len(x)), x)
    return x.astype(np.float32)


def _fill_fields(rate, n_fields, seed=1):
    rng = np.random.default_rng(seed)
    nsu = FRAME_SPECS[rate].payload_info_bits // 96
    return [b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9))))
        for _ in range(nsu)) for _ in range(n_fields)]


def _msk_stream(n_fields, snr=20.0, seed=1):
    fields = _fill_fields(1200, n_fields, seed)
    bits = build_p_frames(fields, 1200, lead_frames=4)
    sig = msk_modulate(bits, 24000, 1200, freq=1000.0)
    p = np.mean(sig ** 2)
    rng = np.random.default_rng(seed + 100)
    sig = sig + rng.normal(0, np.sqrt(p / 10 ** (snr / 10)), len(sig))
    return fields, sig.astype(np.float32)


def _feed_with_slip(outs, framer):
    """Feed demod block outputs through a framer, passing the slip flag
    the way every runtime consumer does."""
    evs = []
    for o in outs:
        evs += framer.feed(o["soft_bits"].astype(np.float32),
                           slip=int(o["slip"]))
    return evs


def _run_msk(fields, sig, device, built=None):
    dm = _keep(MskDemodulator(24000, 1200, device=device), built)
    outs = dm.process(np.concatenate([sig, np.zeros(48000, np.float32)]))
    got = [e.infofield for e in _feed_with_slip(outs, PChannelFramer(1200))]
    return [i for i, f in enumerate(fields) if f in got]


def _oqpsk_stream(n_fields, snr=20.0, seed=1):
    fields = _fill_fields(10500, n_fields, seed)
    bits = build_p_frames(fields, 10500, lead_frames=4)
    sig = oqpsk_modulate(bits, 48000, 10500, freq=8000.0)
    p = np.mean(sig ** 2)
    rng = np.random.default_rng(seed + 100)
    sig = sig + rng.normal(0, np.sqrt(p / 10 ** (snr / 10)), len(sig))
    return fields, sig.astype(np.float32)


def _run_oqpsk(fields, sig, device, built=None):
    dm = _keep(OqpskDemodulator(48000, 10500, device=device), built)
    outs = dm.process(np.concatenate([sig, np.zeros(96000, np.float32)]))
    got = [e.infofield for e in _feed_with_slip(outs, PChannelFramer(10500))]
    return [i for i, f in enumerate(fields) if f in got]


def _wideband_msk_msgs(n_msgs, fs_wb, delta, seed=5):
    """Wideband complex stream carrying n_msgs single-frame ACARS
    messages on an MSK 1200 VFO at +delta Hz off center, as a single
    sideband (the analytic audio upconverted)."""
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    fields = []
    texts = []
    for k in range(n_msgs):
        text = f"SLIP MSG {k:03d}"
        texts.append(text)
        ud = make_acars_userdata("2", "VH-SLP", "!", "AA", "M", text)
        sus = [append_crc16_bytes(b)
               for b in segment_isu(ud, 0x654321, 0x41)]
        sus += [fill] * (6 - len(sus))
        fields.append(b"".join(sus))
    bits = build_p_frames(fields, 1200, lead_frames=4)
    audio = msk_modulate(bits, 24000, 1200, freq=1000.0)
    up = fs_wb // 24000
    an = hilbert(audio.astype(np.float64))
    bb = resample_poly(an, up, 1).astype(np.complex64)
    t = np.arange(len(bb)) / fs_wb
    return texts, (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)


def _ppm_resample_iq(wide, ppm):
    r = 1.0 + ppm * 1e-6
    idx = np.arange(int((len(wide) - 2) / r)) * r
    base = np.arange(len(wide))
    return (np.interp(idx, base, wide.real)
            + 1j * np.interp(idx, base, wide.imag)).astype(np.complex64)


def _acars_fields(msg, aes, nsu_per_field=6):
    ud = make_acars_userdata("2", "N1MIX", "!", "H1", "A", msg)
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, aes, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % nsu_per_field:
        sus.append(fill)
    return [b"".join(sus[i:i + nsu_per_field])
            for i in range(0, len(sus), nsu_per_field)]


def _synth_msk_wb(bits, fs, fb, offset, amp=0.05):
    sps = fs / fb
    e = np.empty_like(bits)
    prev = 0
    for k in range(len(bits)):
        cur = bits[k] ^ prev if k % 2 == 0 else bits[k] ^ prev ^ 1
        e[k] = cur
        prev = cur
    steps = np.repeat((1 - 2 * e.astype(np.float64)) * (np.pi / 2) / sps,
                      int(round(sps)))
    ph = np.concatenate([[0.0], np.cumsum(steps)])[:-1]
    n = np.arange(len(ph))
    return (amp * np.exp(1j * (2 * np.pi * offset / fs * n + ph))
            ).astype(np.complex64)


# ---- the impairment scenarios (tests/test_impairments.py) -----------------

def msk_ramp(rate, device, built=None):
    """A 61 s MSK stream of 56 frames under a Doppler ramp of ``rate``
    Hz/s from -500 Hz."""
    fields, sig = _msk_stream(56)
    return _run_msk(fields, impair(sig, 24000, cfo0=-500.0, ramp=rate),
                    device, built)


def oqpsk_ramp(device, built=None):
    """The C-band case: 120 OQPSK frames (62 s) under 240 Hz/s."""
    fields, sig = _oqpsk_stream(120)
    return _run_oqpsk(fields, impair(sig, 48000, cfo0=-1500.0, ramp=240.0),
                      device, built)


def msk_ppm(ppm, device, built=None):
    fields, sig = _msk_stream(28)          # 33 s
    return _run_msk(fields, impair(sig, 24000, ppm=ppm), device, built)


def oqpsk_ppm(ppm, device, built=None):
    fields, sig = _oqpsk_stream(60)        # 32 s
    return _run_oqpsk(fields, impair(sig, 48000, ppm=ppm), device, built)


def msk_phase_noise(device, built=None):
    fields, sig = _msk_stream(16)
    return _run_msk(fields, impair(sig, 24000, pn=0.005, seed=9), device,
                    built)


def oqpsk_phase_noise(device, built=None):
    fields, sig = _oqpsk_stream(30)
    return _run_oqpsk(fields, impair(sig, 48000, pn=0.002, seed=9), device,
                      built)


def msk_combined(device, built=None):
    """Ramp, clock offset and phase noise at once (35 s)."""
    fields, sig = _msk_stream(30)
    x = impair(sig, 24000, cfo0=-500.0, ramp=40.0, ppm=60.0, pn=0.003)
    return _run_msk(fields, x, device, built)


SLIP_INI = ("[General]\nsample_rate=288000\ncenter_frequency=1545000000\n"
            "[vfos]\nsize=1\n1\\frequency=1545024000\n1\\data_rate=1200\n"
            "1\\topic=V1\n1\\gain=100\n")


def _fused_texts(wide, ini, device, texts, built):
    """``wide`` (two blocks of zeros appended) through a FusedStation of
    ``ini`` on ``device``: the ``texts`` it decoded."""
    msgs = []
    st = _keep(FusedStation(load_ini(ini, is_text=True), device=device,
                            on_acars=lambda t, it: msgs.append(it.message)),
               built)
    w = np.concatenate([wide, np.zeros(2 * st.block_len, np.complex64)])
    for i in range(0, (len(w) // st.block_len) * st.block_len, st.block_len):
        st.process(w[i:i + st.block_len])
    st.flush()
    return [t for t in texts if t in msgs]


def fused_ppm(device, built=None):
    """400 ppm through the FusedStation: the slip rides the packed device
    telemetry and the drain realigns the soft stream."""
    texts, wide = _wideband_msk_msgs(10, 288000, 24000)
    return _fused_texts(_ppm_resample_iq(wide, 400.0), SLIP_INI, device,
                        texts, built)


def fused_ramp(device, built=None):
    """A 40 Hz/s Doppler ramp on the wideband IQ through the
    FusedStation."""
    texts, wide = _wideband_msk_msgs(12, 288000, 24000)
    t = np.arange(len(wide)) / 288000
    wide = (wide * np.exp(2j * np.pi * (0.5 * 40.0) * t * t)
            ).astype(np.complex64)
    return _fused_texts(wide, SLIP_INI, device, texts, built)


def classic_ppm(device, built=None):
    """The 400 ppm stream through the classic Station's VfoBank path."""
    texts, wide = _wideband_msk_msgs(10, 288000, 24000)
    wide = _ppm_resample_iq(wide, 400.0)
    cfg = load_ini(SLIP_INI, is_text=True)
    msgs = []
    st = _keep(Station(cfg, device=device,
                       on_acars=lambda t, it: msgs.append(it.message)),
               built)
    B = cfg.buflen_complex
    w = np.concatenate([wide, np.zeros(2 * B, np.complex64)])
    for i in range(0, (len(w) // B) * B, B):
        st.process(w[i:i + B])
    return [t for t in texts if t in msgs]


def fused_c_channel_ppm(device, built=None):
    """Nine 8400 C frames under a 100 ppm clock offset through the
    FusedStation: the voice frames that came out.  The channel is one
    sideband (the analytic audio upconverted) and the offset a complex
    resample_poly of the IQ (see tests/test_impairments.py)."""
    rng = np.random.default_rng(11)
    cframes = []
    for _ in range(9):
        csus = [append_crc16_bytes(
            bytes([0x30]) + bytes(rng.integers(0, 256, 9,
                                               dtype=np.uint8).tolist()))
            for _ in range(3)]
        voice = bytes(rng.integers(0, 256, 300, dtype=np.uint8).tolist())
        cframes.append((csus, voice))
    audio = oqpsk_modulate(build_c_frames(cframes, lead_frames=4),
                           48000, 8400, freq=8000.0)
    up = 6                                  # 288000 / 48000
    an = hilbert(audio.astype(np.float64))
    x = np.zeros(len(an) * up, np.complex128)
    x[::up] = an * up
    bb = lfilter(firwin(511, 1.0 / up), 1.0, x)
    t = np.arange(len(bb)) / 288000.0
    wide = (bb * np.exp(2j * np.pi * 96000.0 * t)).astype(np.complex64)
    wide = resample_poly(wide.astype(np.complex128),
                         10000, 10001).astype(np.complex64)   # +100 ppm
    ini = ("[General]\nsample_rate=288000\ncenter_frequency=1545000000\n"
           "[vfos]\nsize=1\n1\\frequency=1545096000\n1\\data_rate=8400\n"
           "1\\topic=C1\n1\\gain=100\n")
    voices = []
    st = _keep(FusedStation(load_ini(ini, is_text=True), device=device,
                            on_voice=lambda t_, d, hx: voices.append(d)),
               built)
    w = np.concatenate([wide, np.zeros(2 * st.block_len, np.complex64)])
    for i in range(0, (len(w) // st.block_len) * st.block_len, st.block_len):
        st.process(w[i:i + st.block_len])
    st.flush()
    return [v for _, v in cframes if v in voices]


def burst_r_combined(device, built=None):
    """Fourteen R bursts over ~60 s under a ramp, 100 ppm and phase
    noise: the kinds of the packets decoded (the R/T framer's checkpoint
    decodes run the Viterbi kernel on a card)."""
    fs, fb = 12000.0, 600.0
    info = (bytes([0x1B, 0x28, 0x0A, 0x0B, 0x0C, 0x77]) + b"IMPAIRED BST"
            ).ljust(17, b"\0")[:17]
    burst = msk_modulate(build_r_burst(info, preamble_bits=96),
                         fs, fb, freq=2600.0, amplitude=0.3)
    rng = np.random.default_rng(3)
    parts = [np.zeros(20000, np.float32)]
    for _ in range(14):
        parts += [burst, np.zeros(40000, np.float32)]
    sig = np.concatenate(parts)
    p = np.mean(burst ** 2)
    sig = sig + rng.normal(0, np.sqrt(p / 10 ** 1.0),
                           len(sig)).astype(np.float32)
    x = impair(sig, fs, cfo0=-100.0, ramp=4.0, ppm=100.0, pn=0.003,
               seed=11)
    dm = _keep(BurstMskDemodulator(fs, fb, device=device), built)
    fr = RTChannelFramer(decoder=stream_decoder(device))
    kinds = []
    for i in range(0, (len(x) // 16000) * 16000, 16000):
        for o in dm.process(x[i:i + 16000]):
            if o["burst"]:
                kinds += [e.kind for e in fr.feed(o["soft_bits"])]
    return [k for k in kinds if k == "R"]


# name -> (runner(device, built=None), how many it sends, JAX's threshold
# on what comes back), in the order of tests/test_impairments.py
ENVELOPES = {
    "msk_ramp_25": (functools.partial(msk_ramp, 25.0), 56, 52),
    "msk_ramp_150": (functools.partial(msk_ramp, 150.0), 56, 48),
    "oqpsk_ramp_240": (oqpsk_ramp, 120, 112),
    "msk_ppm_+100": (functools.partial(msk_ppm, 100.0), 28, 27),
    "msk_ppm_-100": (functools.partial(msk_ppm, -100.0), 28, 27),
    "msk_ppm_+500": (functools.partial(msk_ppm, 500.0), 28, 26),
    "oqpsk_ppm_+100": (functools.partial(oqpsk_ppm, 100.0), 60, 57),
    "oqpsk_ppm_-100": (functools.partial(oqpsk_ppm, -100.0), 60, 57),
    "msk_phase_noise": (msk_phase_noise, 16, 14),
    "oqpsk_phase_noise": (oqpsk_phase_noise, 30, 27),
    "fused_ppm_400": (fused_ppm, 10, 9),
    "fused_ramp_40": (fused_ramp, 12, 10),
    "classic_ppm_400": (classic_ppm, 10, 9),
    "fused_c_ppm_100": (fused_c_channel_ppm, 9, 6),
    "msk_combined": (msk_combined, 30, 26),
    "burst_r_combined": (burst_r_combined, 14, 12),
}

# the ramps' steady state, past the acquisition transient: name -> (first
# frame index counted, frames from there on, JAX's least share recovered)
STEADY = {
    "msk_ramp_25": (16, 40, 0.95),
    "msk_ramp_150": (16, 40, 0.9),
    "oqpsk_ramp_240": (20, 100, 0.9),
}


# ---- the fused soak (tests/test_soak.py) ----------------------------------

SOAK_TEXTS = ("SOAK ON TUNE", "SOAK HUNTED", "SOAK BURST")


def fused_soak(device, workdir, built=None):
    """Everything at once through one FusedStation on ``device`` (int16
    ingest, batched host framing, hunting with 2 tries): an on-tune 1200
    carrier, a 600 carrier 1500 Hz off its tune that only the hunter
    finds, and a T burst in the second half, with a checkpoint written to
    ``workdir`` halfway and restored into a fresh station.  Returns the
    (VFO, text) of every ACARS message and the restored station's
    ``vfo_telemetry()``."""
    fs, center = 288000, 1545000000
    ini = (f"sample_rate={fs}\ncenter_frequency={center}\n[vfos]\nsize=3\n"
           f"1\\frequency={center + 24000}\n1\\data_rate=1200\n1\\topic=ON\n"
           f"2\\frequency={center - 24000}\n2\\data_rate=600\n2\\topic=OFF\n"
           f"3\\frequency={center + 60000}\n3\\data_rate=600\n3\\topic=BR\n"
           "3\\burst=1\n")
    cfg = load_ini(ini, is_text=True)

    def up_wb(audio, fsa, delta, dur):
        u = fs // fsa
        x = np.zeros(len(audio) * u, np.float32)
        x[::u] = np.asarray(audio) * u
        bb = lfilter(firwin(511, 1.0 / u), 1.0, x).astype(np.complex64)
        t = np.arange(len(bb)) / fs
        w = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)
        out = np.zeros(dur, np.complex64)
        out[: min(len(w), dur)] = w[:dur]
        return out

    rng = np.random.default_rng(31)
    dur = 14 * fs
    wb = np.zeros(dur, np.complex64)
    f_on = _acars_fields("SOAK ON TUNE", 0x111111)
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(f_on[-1]) < 72:
        f_on[-1] += fill
    bits_on = build_p_frames(f_on * 8, 1200, lead_frames=3)
    wb += up_wb(msk_modulate(bits_on, 24000, 1200.0, freq=1000.0), 24000,
                24000, dur)
    f_off = _acars_fields("SOAK HUNTED", 0x222222)
    bits_off = build_p_frames(f_off * 5, 600, lead_frames=3)
    wb += up_wb(msk_modulate(bits_off, 12000, 600.0, freq=2500.0), 12000,
                -24000, dur)
    bsus = segment_isu(make_acars_userdata("2", "NSOAK", "!", "H1", "A",
                                           "SOAK BURST"), 0x333333, 0x41)
    bt = build_t_burst(0x333333, 0x41, bsus, preamble_bits=96)
    burst_audio = np.concatenate([
        np.zeros(8 * 12000, np.float32),
        msk_modulate(bt, 12000, 600.0, freq=3000.0) * 1.6])
    wb += up_wb(burst_audio, 12000, 60000, dur)
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)

    def mk(sink):
        return _keep(FusedStation(
            cfg, ingest_dtype="int16", hunt_max_tries=2, device=device,
            on_acars=lambda v, it: sink.append((v, it.message))), built)

    w = np.concatenate([wb, np.zeros(3 * 96000, np.complex64)])
    got = []
    st = mk(got)
    blocks = [w[i:i + st.block_len]
              for i in range(0, (len(w) // st.block_len) * st.block_len,
                             st.block_len)]
    half = len(blocks) // 2
    for b in blocks[:half]:
        st.process(b)
    ck = os.path.join(workdir, "soak.npz")
    st.save_checkpoint(ck)
    st2 = mk(got)
    st2.load_checkpoint(ck)
    for b in blocks[half:]:
        st2.process(b)
    st2.flush()
    return got, st2.vfo_telemetry()
