"""Port parity: the burst R/T path (detection statistics, the MSK and
OQPSK window demodulators, the R/T framer with its injected decoder).

The same inputs, made from a numpy seed, go through the JAX functions and
the port's.  Tolerances, and why:
- ``convolve_same`` against ``np.convolve(mode="same")`` in float64:
  1e-5 (float32 sums of at most 256 terms);
- ``_envelope`` and ``_autocorr_rho``, on an odd and an even smoothing
  length (255, 256): 1e-4 relative to the largest value (float32
  convolutions and FFTs summed in another order);
- window demodulators (MSK at sps 20 and 5, so gate dilations of 160
  and 40 samples, even as every 8*sps is; OQPSK at 48 and 45 kS/s, a
  fractional strobe step of 32/7 and 30/7): ``active`` equal, soft values
  within +-1, ``freq_offset`` within 0.5 Hz (the coarse fold and the
  tone grid argmaxes pick the same bins; the rest is float32);
- over the air (the tests/test_burst.py scenarios, and the low-SNR
  points of tests/test_burst_sensitivity.py's sweeps) and on the bit
  level: the same R/T packets and ACARS as JAX, exactly.
"""

import numpy as np
import pytest
import torch

from aero_tpu.models import burst_common as jbc
from aero_tpu.models import burst_msk as jbm
from aero_tpu.models import burst_oqpsk as jbo
from aero_tpu.models.msk import msk_modulate
from aero_tpu.models.oqpsk import oqpsk_modulate
from aero_tpu.protocol import rt_framing as jrt
from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.models import burst_common as tbc
from aero_tpu_torch.models import burst_msk as tbm
from aero_tpu_torch.models import burst_oqpsk as tbo
from aero_tpu_torch.ops.fir import convolve_same
from aero_tpu_torch.protocol import rt_framing as trt
from tests.test_burst import _acars_sus, _bits_to_stream, _r_info

torch.set_num_threads(2)


@pytest.mark.parametrize("n,m", [(1000, 7), (1000, 8), (4096, 256),
                                 (300, 299)])
def test_convolve_same_aligns_as_numpy(n, m):
    rng = np.random.default_rng(n + m)
    x = rng.standard_normal(n).astype(np.float32)
    k = rng.standard_normal(m).astype(np.float32)
    want = np.convolve(x.astype(np.float64), k.astype(np.float64), "same")
    got = convolve_same(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    z = (x + 1j * x[::-1]).astype(np.complex64)
    want = np.convolve(z.astype(np.complex128), k.astype(np.float64), "same")
    got = convolve_same(torch.from_numpy(z), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _burst_audio(fs, fb, oqpsk, seed, snr_db=12.0):
    """One R burst (MSK) or T burst (OQPSK) in noise, 16384 samples."""
    rng = np.random.default_rng(seed)
    if oqpsk:
        bits = jrt.build_t_burst(0x123456, 0x41, _acars_sus(), oqpsk=True,
                                 preamble_bits=128)
        sig = oqpsk_modulate(bits, fs, fb, freq=7400.0, amplitude=0.3)
    else:
        bits = jrt.build_r_burst(_r_info(), preamble_bits=96)
        sig = msk_modulate(bits, fs, fb, freq=fs / 4.0 + 123.0,
                           amplitude=0.3)
    x = np.zeros(3 * 16384, np.float32)
    x[3000:3000 + len(sig)] = sig[: len(x) - 3000]
    p = np.mean(sig ** 2)
    x += rng.normal(0, np.sqrt(p / 10 ** (snr_db / 10)), len(x)).astype(
        np.float32)
    return x


@pytest.mark.parametrize("smooth", [255, 256])
def test_detection_statistics(smooth):
    x = _burst_audio(12000.0, 600.0, False, seed=1)[:32768]
    je = np.asarray(jbm._envelope(x, smooth))
    te = tbm._envelope(torch.from_numpy(x), smooth).numpy()
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-4 * np.abs(je).max())
    for lag in (40, 9):
        jr = np.asarray(jbc._autocorr_rho(x, lag, smooth))
        tr = tbc._autocorr_rho(torch.from_numpy(x), lag, smooth).numpy()
        np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4 * jr.max())


def _gate(x, smooth):
    env = np.convolve(x * x, np.ones(smooth) / smooth, "same")
    return (env > 3.0 * np.percentile(env, 25)).astype(np.float32)


def _check_window(jout, tout):
    ja = np.asarray(jout["active"])
    np.testing.assert_array_equal(tout["active"].numpy(), ja)
    assert ja.sum() > 100
    d = np.abs(tout["soft"].numpy() - np.asarray(jout["soft"]))
    assert d.max() <= 1, d.max()
    assert abs(float(tout["freq_offset"])
               - float(jout["freq_offset"])) < 0.5
    np.testing.assert_allclose(float(tout["tone_quality"]),
                               float(jout["tone_quality"]), rtol=1e-3)


@pytest.mark.parametrize("fs,fb", [(12000.0, 600.0), (24000.0, 1200.0),
                                   (6000.0, 1200.0)])
def test_burst_msk_window(fs, fb):
    cfg_j = jbm.make_config(fs, fb)
    cfg_t = tbm.make_config(fs, fb)
    assert tuple(cfg_t) == tuple(cfg_j)
    x = _burst_audio(fs, fb, False, seed=2)[: cfg_j.window_len]
    gate = _gate(x, 8 * cfg_j.sps)
    fc = np.float32(cfg_j.freq_center + 40.0)
    jout = jbm.burst_msk_window(x, gate, cfg_j, fc)
    tout = tbm.burst_msk_window(torch.from_numpy(x), torch.from_numpy(gate),
                                cfg_t, fc)
    _check_window(jout, tout)


@pytest.mark.parametrize("fs", [48000.0, 45000.0])
def test_burst_oqpsk_window(fs):
    cfg_j = jbo.make_config(fs, 10500.0)
    cfg_t = tbo.make_config(fs, 10500.0)
    assert tuple(cfg_t) == tuple(cfg_j)
    x = _burst_audio(fs, 10500.0, True, seed=3)[: cfg_j.window_len]
    gate = _gate(x, 33)
    fc = np.float32(7300.0)
    jout = jbo.burst_oqpsk_window(x, gate, cfg_j, fc)
    tout = tbo.burst_oqpsk_window(torch.from_numpy(x),
                                  torch.from_numpy(gate), cfg_t, fc)
    _check_window(jout, tout)


def _over_the_air(demod, framer_mod, sig, fs, fb, oqpsk):
    port = demod.__module__.startswith("aero_tpu_torch")
    dm = demod(fs, fb, **({"device": "cpu"} if port else {}))
    acars = []
    fr = framer_mod.RTChannelFramer(oqpsk=oqpsk, on_acars=acars.append)
    evs, streams = [], []
    for i in range(0, (len(sig) // 16000) * 16000, 16000):
        for o in dm.process(sig[i:i + 16000]):
            if o["burst"]:
                streams.append(o["soft_bits"])
                evs.extend(fr.feed(o["soft_bits"]))
    return ([(e.kind, e.n_sus, e.infofield) for e in evs],
            [a.message for a in acars], streams)


def _same_packets(jres, tres):
    assert tres[0] == jres[0] and tres[1] == jres[1]
    assert len(tres[2]) == len(jres[2])
    for a, b in zip(tres[2], jres[2]):
        assert a.dtype == np.int16 and len(a) == len(b)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_burst_msk_over_the_air_same_packets():
    """tests/test_burst.py::test_burst_msk_over_the_air through both."""
    fs, fb = 12000.0, 600.0
    rng = np.random.default_rng(2)
    b1 = jrt.build_r_burst(_r_info(), preamble_bits=96)
    b2 = jrt.build_t_burst(0x123456, 0x41, _acars_sus(), preamble_bits=96)
    sig = np.concatenate([
        np.zeros(30000, np.float32),
        msk_modulate(b1, fs, fb, freq=2600.0, amplitude=0.3),
        np.zeros(47000, np.float32),
        msk_modulate(b2, fs, fb, freq=3777.0, amplitude=0.3),
        np.zeros(60000, np.float32)])
    p = np.mean(msk_modulate(b1, fs, fb) ** 2)
    sig += rng.normal(0, np.sqrt(p / 10), len(sig)).astype(np.float32)
    jres = _over_the_air(jbm.BurstMskDemodulator, jrt, sig, fs, fb, False)
    tres = _over_the_air(tbm.BurstMskDemodulator, trt, sig, fs, fb, False)
    _same_packets(jres, tres)
    assert [(k, n) for k, n, _ in tres[0]] == [("R", 0), ("T", 6)]
    assert "TEST VIA T CHANNEL" in tres[1]


def test_burst_oqpsk_over_the_air_same_packets():
    """tests/test_burst.py::test_burst_oqpsk_over_the_air through both."""
    fs, fb = 48000.0, 10500.0
    rng = np.random.default_rng(3)
    b = jrt.build_t_burst(0x123456, 0x41, _acars_sus(), oqpsk=True,
                          preamble_bits=128)
    sig = np.concatenate([
        np.zeros(40000, np.float32),
        oqpsk_modulate(b, fs, fb, freq=7400.0, amplitude=0.3),
        np.zeros(80000, np.float32)])
    sig += rng.normal(0, 0.02, len(sig)).astype(np.float32)
    jres = _over_the_air(jbo.BurstOqpskDemodulator, jrt, sig, fs, fb, True)
    tres = _over_the_air(tbo.BurstOqpskDemodulator, trt, sig, fs, fb, True)
    _same_packets(jres, tres)
    assert [(k, n) for k, n, _ in tres[0]] == [("T", 6)]
    assert tres[1] == ["TEST VIA T CHANNEL"]


@pytest.mark.parametrize("oqpsk,snr_db", [(False, 0.0), (False, -2.0),
                                          (True, 0.0), (True, -2.0)])
def test_burst_sensitivity_same_packets(oqpsk, snr_db):
    """The signals of tests/test_burst_sensitivity.py's sweeps at their
    two lowest SNR points: three R bursts (MSK 600) or three T bursts
    (OQPSK 10500) in AWGN; the port frames the same packets as JAX."""
    rng = np.random.default_rng(abs(int(10 * snr_db)) + (3 if oqpsk else 1))
    if oqpsk:
        fs, fb, gap, lead = 48000.0, 10500.0, 80000, 40000
        sus = segment_isu(make_acars_userdata(
            "2", "VH-OQB", "!", "H1", "A", "TEST VIA T CHANNEL"),
            0x123456, 0x41)
        burst = oqpsk_modulate(jrt.build_t_burst(
            0x123456, 0x41, sus, oqpsk=True, preamble_bits=128),
            fs, fb, freq=7400.0, amplitude=0.3)
        demods = (jbo.BurstOqpskDemodulator, tbo.BurstOqpskDemodulator)
    else:
        fs, fb, gap, lead = 12000.0, 600.0, 40000, 30000
        info = (bytes([0x1B, 0x28, 0x0A, 0x0B, 0x0C, 0x77]) + b"LOW SNR BST"
                ).ljust(17, b"\0")
        burst = msk_modulate(jrt.build_r_burst(info, preamble_bits=96),
                             fs, fb, freq=2600.0, amplitude=0.3)
        demods = (jbm.BurstMskDemodulator, tbm.BurstMskDemodulator)
    sig = np.concatenate([np.zeros(lead, np.float32)]
                         + [burst, np.zeros(gap, np.float32)] * 3)
    p = np.mean(burst ** 2)
    sig = sig + rng.normal(0, np.sqrt(p / 10 ** (snr_db / 10)),
                           len(sig)).astype(np.float32)
    jres = _over_the_air(demods[0], jrt, sig, fs, fb, oqpsk)
    tres = _over_the_air(demods[1], trt, sig, fs, fb, oqpsk)
    _same_packets(jres, tres)
    assert len(tres[0]) >= 2


def test_no_bursts_in_noise():
    rng = np.random.default_rng(4)
    dm = tbm.BurstMskDemodulator(12000, 600, device="cpu")
    got = []
    for _ in range(6):
        for o in dm.process(rng.normal(0, 0.1, 16000).astype(np.float32)):
            got.append(bool(o["burst"]))
    assert not any(got)


@pytest.mark.parametrize("oqpsk", [False, True])
def test_rt_bit_level_same_as_jax(oqpsk):
    """Framer alone on a clean bit stream: the port's framer with its
    default decoder (the plain twin on a one-row CPU tensor) and with an
    explicit one give JAX's R and T packets."""
    from aero_tpu_torch.ops.viterbi_kernel import stream_decoder

    streams = [_bits_to_stream(jrt.build_r_burst(_r_info(), oqpsk=oqpsk)),
               _bits_to_stream(jrt.build_t_burst(0x123456, 0x41,
                                                 _acars_sus(), oqpsk=oqpsk))]
    res = []
    for mod, kw in ((jrt, {}), (trt, {}),
                    (trt, {"decoder": stream_decoder("cpu")})):
        acars = []
        evs = []
        for s in streams:
            fr = mod.RTChannelFramer(oqpsk=oqpsk, on_acars=acars.append,
                                     **kw)
            evs += [(e.kind, e.n_sus, e.infofield) for e in fr.feed(s)]
        res.append((evs, [a.message for a in acars]))
    assert res[1] == res[0] and res[2] == res[0]
    assert [(k, n) for k, n, _ in res[0][0]] == [("R", 0), ("T", 6)]


# ---- the detection on the device against the host loop it replaced ------
#
# ``process`` keeps the ring on the device and scans the statistics on the
# host only when the device counts a candidate run.  The oracle
# (tests/torch_burst_oracle.py) is the host-loop ``process`` of the commit
# before, fed by the port's own ``_envelope`` and ``_autocorr_rho``: after
# every block both give the same outputs, the same ring and the same
# noise floor, bit for bit.

def _t_burst(fs, fb, oqpsk, amplitude=0.3):
    bits = jrt.build_t_burst(0x123456, 0x41, _acars_sus(), oqpsk=oqpsk,
                             preamble_bits=128 if oqpsk else 96)
    if oqpsk:
        return oqpsk_modulate(bits, fs, fb, freq=7400.0, amplitude=amplitude)
    return msk_modulate(bits, fs, fb, freq=fs / 4.0 + 60.0,
                        amplitude=amplitude)


def _r_burst(fs, fb, amplitude=0.3):
    return msk_modulate(jrt.build_r_burst(_r_info(), preamble_bits=96), fs,
                        fb, freq=fs / 4.0 - 50.0, amplitude=amplitude)


# (burst, start sample, SNR dB) of each scenario; "noise" plants none
_SCENES = {
    "noise": (24, []),
    # R and T bursts well above the detector's floor
    "bursts": (14, [("r", 20000, 10.0), ("t", 70000, 10.0),
                    ("r", 150000, 14.0)]),
    # the sensitivity sweep's lowest points, where rho hovers near 0.35
    "near_threshold": (14, [("r", 9000, -2.0), ("t", 60000, -1.0),
                            ("r", 140000, -4.0), ("r", 180000, 0.0)]),
    # a burst across a block edge, a T burst whose window is held over a
    # block (its gate run ends at the ring's end), one ending on an edge
    "edges": (16, [("r", 2 * 16000 - 2500, 8.0), ("t", 6 * 16000 - 9000, 8.0),
                   ("r", 13 * 16000 - 9000, 8.0)]),
}


def _scene(kind, name, seed):
    """The scenario's signal for an MSK 1200 watcher at 24 kS/s (the L
    band's R watchers; its T bursts MSK too) or an OQPSK 10500 one at
    48 kS/s (the C band's T watchers), in blocks of 16000."""
    fs, fb = (24000.0, 1200.0) if kind == "msk" else (48000.0, 10500.0)
    blocks, plan = _SCENES[name]
    rng = np.random.default_rng(seed)
    ref = _t_burst(fs, fb, kind == "oqpsk")
    x = np.zeros(blocks * 16000, np.float32)
    noise = np.sqrt(np.mean(ref ** 2) / 10)
    for what, start, snr_db in plan:
        b = (_r_burst(fs, fb) if what == "r" and kind == "msk"
             else _t_burst(fs, fb, kind == "oqpsk"))
        if kind == "oqpsk" and what == "r":
            b = b[: len(b) // 3]                  # a short OQPSK burst
        gain = noise * np.sqrt(10 ** (snr_db / 10) / np.mean(b ** 2))
        x[start:start + len(b)] += (gain * b)[: len(x) - start]
    x += rng.normal(0, noise, len(x)).astype(np.float32)
    return fs, fb, x


def _same_block(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("name", list(_SCENES))
@pytest.mark.parametrize("kind", ["msk", "oqpsk"])
def test_process_is_the_host_loop_bit_for_bit(kind, name):
    """Block by block: the outputs, ``_ring`` and ``_noise_floor`` (the
    float's bits) of the device-detection ``process`` equal the host
    loop's.  The burst scenarios emit windows and the noise one none."""
    from torch_burst_oracle import HostLoop
    fs, fb, x = _scene(kind, name, seed=len(name))
    cls = tbm.BurstMskDemodulator if kind == "msk" else tbo.BurstOqpskDemodulator
    dm = cls(fs, fb, device="cpu")
    oracle = HostLoop(cls(fs, fb, device="cpu"))
    bursts = 0
    for i in range(0, len(x), 16000):
        got = dm.process(x[i:i + 16000])
        _same_block(got, oracle.process(x[i:i + 16000]))
        ring = dm._ring
        assert ring.dtype == np.float32
        assert np.array_equal(ring, oracle._ring)
        assert type(dm._noise_floor) is float
        assert dm._noise_floor == oracle._noise_floor
        bursts += sum(o["burst"] for o in got)
    if name == "noise":
        assert bursts == 0
    else:
        assert bursts >= 2


# ---- the three places where the device must round as numpy does ---------

def _percentile_cases():
    rng = np.random.default_rng(7)
    yield "random", rng.random(16384).astype(np.float32) * 3
    yield "tied", rng.integers(0, 5, 16384).astype(np.float32) / 7
    yield "zeros", np.zeros(16384, np.float32)
    yield "envelope", np.abs(rng.standard_normal(16384)).astype(
        np.float32) ** 2 * 1e-3


@pytest.mark.parametrize("case", ["random", "tied", "zeros", "envelope"])
def test_device_q25_is_numpys_percentile(case):
    """``_q25`` over the first n of a bucket, for n of every residue mod 4
    (each interpolation weight) down to 1, and 0, equals
    ``np.percentile(..., 25.0)`` in value and dtype bit for bit; a float64
    interpolation of the same order statistics would not (on the random
    arrays)."""
    x = dict(_percentile_cases())[case]
    garbage = x.copy()
    garbage[::3] = -1.0                      # past n: never read
    idx = torch.arange(len(x))
    lerp64 = 0
    for n in (1, 2, 3, 4, 5, 7, 100, 1001, 4098, 9999, 16383, 16384):
        buf = np.concatenate([x[:n], garbage[n:]])
        want = np.percentile(x[:n], 25.0)
        got = tbc._q25(torch.from_numpy(buf), idx < n,
                       torch.from_numpy(tbc._scan_plan(n, 0.0)))
        assert got.numpy().dtype == want.dtype
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), n
        s = np.sort(x[:n]).astype(np.float64)
        v = (n - 1) / 4
        lo = int(v)
        hi = min(lo + 1, n - 1)
        lerp64 += float(np.float32(s[lo] + (s[hi] - s[lo]) * (v - lo))) \
            != float(want)
    empty = tbc._q25(torch.from_numpy(garbage), idx < 0,
                     torch.from_numpy(tbc._scan_plan(0, 0.0)))
    assert empty.item() == 0.0
    if case == "random":
        assert lerp64 > 0


def test_thresholds_compare_in_float32():
    """``env > gate_ratio * nf`` and ``rho > rho_threshold`` compare a
    float32 array with a Python float (not a numpy float64, which would
    promote), which numpy rounds to float32 first: ``_above``, given the threshold as a float or as a float64 0-d
    tensor, equals numpy on the float32 values around each threshold,
    where a float64 comparison differs."""
    rng = np.random.default_rng(11)
    nf = rng.random(40) * 1e-2
    differs = 0
    for thr in [0.35, 0.1, 1 / 3] + [2.5 * float(v) for v in nf]:
        t32 = np.float32(thr)
        x = np.array([np.nextafter(t32, -np.inf), t32,
                      np.nextafter(t32, np.inf)], np.float32)
        want = x > thr
        for t in (thr, torch.tensor(thr, dtype=torch.float64)):
            got = tbc._above(torch.from_numpy(x), t).numpy()
            assert np.array_equal(got, want), (thr, got, want)
        differs += not np.array_equal(x.astype(np.float64) > thr, want)
    assert differs > 10


@pytest.mark.parametrize("min_len", [1, 2, 160, 320, 700])
def test_long_runs_count_bool_runs(min_len):
    """``_long_runs`` over the first n of a bucket (the mask past n False,
    as the arms make it) equals the count of ``_bool_runs`` with its
    length filter: runs of every length, runs touching both ends of the
    ring and of the bucket."""
    rng = np.random.default_rng(min_len)
    lengths = rng.integers(1, 2 * min_len + 3, 400)
    mask = np.repeat(np.arange(400) % 2 == 0, lengths)[:16384]
    mask = np.concatenate([mask, np.ones(16384 - len(mask), bool)])
    for n in (0, 1, min_len, 5000, 9001, 16383, 16384):
        m = mask.copy()
        m[n:] = False
        want = sum(e - s >= min_len for s, e in tbc._bool_runs(mask[:n]))
        got = tbc._long_runs(torch.from_numpy(m), min_len)
        assert int(got) == want, n
