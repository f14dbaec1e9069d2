"""Port parity for the single-VFO CLIs and ACARS application decoding:
``aero_tpu_torch.runtime.{decode_main,publish_main,station_main}``.

- ``decode_main --device cpu`` prints JAX's jsondump records (timestamps
  aside) on tests/fixtures/synthetic_1200.wav and on a burst R capture,
  and writes JAX's voice bytes on an 8400 C-channel capture (the
  scenarios of tests/test_runtime.py).
- ``publish_main`` sends JAX's ZMQ frames (topic, little-endian rate,
  payload; the reference's framing) for a short IQ file: the same topics
  and rates in the same order, payloads within the channelizer parity of
  tests/test_torch_channelizer.py (int16 audio within one LSB).  The
  port's ZMQ transport round-trips a message over a localhost socket.
- One CPDLC uplink, carried over the air on a P channel, gives the same
  ``station_main`` JSON from both packages, its ``cpdlc`` decode
  included.
- The demodulator classes and every new entry point default to the card:
  without one they raise.
"""

import json
import os
import wave

import numpy as np
import pytest
import torch

from aero_tpu.runtime import decode_main as jax_decode
from aero_tpu.runtime import publish_main as jax_publish
from aero_tpu.runtime import station_main as jax_station
from aero_tpu_torch.runtime import decode_main as torch_decode
from aero_tpu_torch.runtime import publish_main as torch_publish
from aero_tpu_torch.runtime import station_main as torch_station
from tests.test_torch_channelizer import _check_outputs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "synthetic_1200.wav")


def _records(out: str):
    recs = []
    for line in out.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            r.pop("t", None)
            recs.append(r)
    return recs


def _wav(path, audio, rate):
    pcm = np.clip(audio * 32767, -32767, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _both_decode(capsys, argv):
    """(JAX records, port records) of one decode_main command line."""
    assert jax_decode.main(argv + ["--platform", "cpu"]) == 0
    want = _records(capsys.readouterr().out)
    assert torch_decode.main(argv + ["--device", "cpu"]) == 0
    got = _records(capsys.readouterr().out)
    return want, got


def _burst_wav(path):
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu.protocol.rt_framing import build_t_burst
    sus = segment_isu(make_acars_userdata("2", "NBURST", "!", "H1", "A",
                                          "BURST RUNTIME"), 0x333444, 0x41)
    bits = build_t_burst(0x333444, 0x41, sus, preamble_bits=96)
    a = np.concatenate([np.zeros(30000, np.float32),
                        msk_modulate(bits, 12000, 600, freq=3100.0,
                                     amplitude=0.3),
                        np.zeros(40000, np.float32)])
    _wav(path, a, 12000)


@pytest.mark.parametrize("scenario", ["fixture_1200", "burst_600"])
def test_decode_main_same_records_as_jax(tmp_path, capsys, scenario):
    if scenario == "fixture_1200":
        argv = ["-b", "1200", "--input-file", FIXTURE]
        n_min = 3
    else:
        p = tmp_path / "b.wav"
        _burst_wav(p)
        argv = ["-b", "600", "--burst", "--input-file", str(p)]
        n_min = 1
    argv += ["--format", "jsondump", "-s", "TEST"]
    want, got = _both_decode(capsys, argv)
    assert len(want) >= n_min
    assert got == want
    if scenario == "burst_600":
        assert want[0]["isu"]["acars"]["reg"] == "NBURST"


def test_decode_main_8400_same_voice_as_jax(tmp_path, capsys):
    from aero_tpu.models.oqpsk import oqpsk_modulate
    from aero_tpu.protocol.c_framing import build_c_frames
    from aero_tpu.protocol.crc import append_crc16_bytes
    rng = np.random.default_rng(0)
    frames = [([append_crc16_bytes(bytes([0x30]) + bytes(
        rng.integers(0, 256, 9, dtype=np.uint8).tolist())) for _ in range(3)],
        bytes(rng.integers(0, 256, 300, dtype=np.uint8).tolist()))
        for _ in range(2)]
    p = tmp_path / "c.wav"
    _wav(p, oqpsk_modulate(build_c_frames(frames, lead_frames=3), 48000,
                           8400, freq=8000.0), 48000)
    jv, tv = tmp_path / "jax.voice", tmp_path / "torch.voice"
    argv = ["-b", "8400", "--input-file", str(p)]
    assert jax_decode.main(argv + ["--platform", "cpu",
                                   "--voice-out", str(jv)]) == 0
    assert torch_decode.main(argv + ["--device", "cpu",
                                     "--voice-out", str(tv)]) == 0
    got = tv.read_bytes()
    assert got == jv.read_bytes()
    assert frames[0][1] in got and frames[1][1] in got


class _Recorder:
    """Stands in for a publisher's socket: keeps each frame sent."""

    def __init__(self, sink):
        self.sink = sink

    def send(self, data, flags=0):
        self.sink.append(bytes(data))

    def close(self, linger=0):
        pass


def _recording_publisher(monkeypatch, module, sink):
    """Patch ``module.ZmqPublisher`` so that the CLI's publisher frames
    its messages as usual and the frames land in ``sink``."""
    base = module.ZmqPublisher

    class Recording(base):
        def __init__(self, address, bind=True, legacy_topic_len5=False):
            self.legacy_topic_len5 = legacy_topic_len5
            self.address = address
            self.sock = _Recorder(sink)
    monkeypatch.setattr(module, "ZmqPublisher", Recording)


@pytest.mark.parametrize("legacy", [False, True])
def test_publish_main_same_frames_as_jax(tmp_path, monkeypatch, legacy):
    from aero_tpu.io import zmq_transport as jz
    from aero_tpu_torch.io import zmq_transport as tz
    from tests.test_torch_channelizer import INI_TREE, _wide
    ini = tmp_path / "p.ini"
    ini.write_text(INI_TREE)
    iq = tmp_path / "w.cf32"
    (4 * np.concatenate([_wide(384000, 1), _wide(384000, 2)])).astype(
        np.complex64).tofile(iq)
    argv = ["-c", str(ini), "--iq-file", str(iq)]
    argv += ["--legacy-topic-len5"] if legacy else []
    frames = {}
    for name, mod, main, extra in (
            ("jax", jz, jax_publish.main, ["--platform", "cpu"]),
            ("torch", tz, torch_publish.main, ["--compute-device", "cpu"])):
        frames[name] = []
        _recording_publisher(monkeypatch, mod, frames[name])
        assert main(argv + extra) == 0
    want, got = frames["jax"], frames["torch"]
    assert len(got) == len(want) == 3 * 2 * 5      # 5 topics x 2 blocks

    def msgs(fr):
        return [(fr[i], int.from_bytes(fr[i + 1], "little"), fr[i + 2])
                for i in range(0, len(fr), 3)]
    gm, wm = msgs(got), msgs(want)
    assert [m[:2] for m in gm] == [m[:2] for m in wm]
    if legacy:
        assert all(len(t) == 5 for t, _, _ in gm)
    topic = (lambda t: t.rstrip(b"\0").decode())
    _check_outputs([(topic(t), r, p) for t, r, p in gm],
                   [(topic(t), r, p) for t, r, p in wm])


def test_port_zmq_wire_roundtrip():
    zmq = pytest.importorskip("zmq")
    import time
    from aero_tpu_torch.io.zmq_transport import ZmqPublisher, ZmqSubscriber
    pub = ZmqPublisher("tcp://127.0.0.1:*", bind=True)
    url = pub.sock.getsockopt_string(zmq.LAST_ENDPOINT)
    sub = ZmqSubscriber(url, "VFO1")
    time.sleep(0.3)   # late-joiner settle
    payload = np.arange(100, dtype="<i2").tobytes()
    got = None
    for _ in range(20):
        pub.publish("VFO1", 24000, payload)
        got = sub.recv(timeout_ms=200)
        if got:
            break
    pub.close()
    sub.close()
    assert got == ("VFO1", 24000, payload)


# a one-VFO P channel at 288 kS/s carrying one CPDLC uplink
_INI_CPDLC = ("[General]\nsample_rate=288000\ncenter_frequency=1545100000\n"
              "[vfos]\nsize=1\n1\\frequency=1545100000\n1\\data_rate=1200\n"
              "1\\topic=VFO1\n1\\gain=100\n")


def _cpdlc_capture(path):
    from scipy.signal import firwin, lfilter
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol import cpdlc
    from aero_tpu.protocol.acars_apps import build_arinc622
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.framing import build_p_frames
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    pay = cpdlc.encode_at1(17, [(0, None)], msg_ref=3, downlink=False)
    text = build_arinc622("AKLCDYA", "AT1", "ZK-OKQ", pay)
    ud = make_acars_userdata("2", "ZK-OKQ", "!", "AA", "M", text)
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0xC80ABC, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
    bits = build_p_frames(fields, 1200, lead_frames=6)
    audio = np.asarray(msk_modulate(bits, 24000, 1200, freq=1000.0))
    up = np.zeros(len(audio) * 12, np.float32)
    up[::12] = audio * 12
    bb = lfilter(firwin(255, 1.0 / 12), 1.0, up).astype(np.float32)
    wb = bb.astype(np.complex64)
    wb = np.concatenate([wb, np.zeros(3 * 57600, np.complex64)])
    wb.tofile(path)
    return text


@pytest.mark.parametrize("backend", ["tree", "fused"])
def test_station_main_cpdlc_json_equals_jax(tmp_path, capsys, backend):
    ini = tmp_path / "c.ini"
    ini.write_text(_INI_CPDLC)
    iq = tmp_path / "c.cf32"
    text = _cpdlc_capture(iq)
    argv = ["-c", str(ini), "--iq-file", str(iq), "--backend", backend,
            "--format", "jsondump", "-s", "TEST", "--stats-every", "1e9"]
    assert jax_station.main(argv + ["--platform", "cpu"]) == 0
    want = _records(capsys.readouterr().out)
    assert torch_station.main(argv + ["--device", "cpu"]) == 0
    got = _records(capsys.readouterr().out)
    assert got == want
    assert len(want) == 1
    acars = want[0]["isu"]["acars"]
    assert acars["msg_text"] == text
    assert acars["app"] == "cpdlc"
    assert acars["cpdlc"]["elements"][0]["title"] == "UNABLE"


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
    from aero_tpu_torch.models.burst_oqpsk import BurstOqpskDemodulator
    from aero_tpu_torch.models.msk import MskDemodulator
    from aero_tpu_torch.models.oqpsk import OqpskDemodulator
    from aero_tpu_torch.parallel.vfo_bank import MskVfoBank
    from aero_tpu_torch.runtime.decoder import Decoder, DecoderOptions
    from aero_tpu_torch.runtime.station import Station
    from aero_tpu_torch.channelizer import load_ini
    for make in (lambda: MskDemodulator(24000, 1200),
                 lambda: OqpskDemodulator(48000, 10500),
                 lambda: BurstMskDemodulator(12000, 600),
                 lambda: BurstOqpskDemodulator(48000, 10500),
                 lambda: MskVfoBank(2, 24000, 1200),
                 lambda: Decoder(DecoderOptions(bitrate=1200)),
                 lambda: Station(load_ini(_INI_CPDLC, is_text=True))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    ini = tmp_path / "c.ini"
    ini.write_text(_INI_CPDLC)
    for main, argv in (
            (torch_decode.main, ["-b", "1200", "--input-file", FIXTURE]),
            (torch_publish.main, ["-c", str(ini), "--iq-stdin"]),
            (torch_station.main, ["-c", str(ini), "--iq-stdin",
                                  "--backend", "tree"])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
