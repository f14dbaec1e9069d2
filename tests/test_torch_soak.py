"""The reference's soak scenarios (tests/test_soak.py) on the port, on the
CPU, with JAX's streams and assertions: 600 and 1200 bps VFOs in one
classic Station, a dropout and relock, the regression fixture's exact
jsondump fields through the port's io/output.py, and the fused station
with everything at once (int16 ingest, batched host framing, hunting, a
T burst) across a checkpoint restore halfway."""

import json

import numpy as np
import torch

import torch_impair as ti
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.io.output import to_output_format
from aero_tpu_torch.models.msk import MskDemodulator, msk_modulate
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import PChannelFramer, build_p_frames
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher
from aero_tpu_torch.runtime.station import Station

torch.set_num_threads(2)


def _dispatch(outs, items_sink):
    disp = PChannelSUDispatcher(on_acars=items_sink)
    soft = np.concatenate([o["soft_bits"] for o in outs]).astype(np.float32)
    for ev in PChannelFramer(1200).feed(soft):
        for k, ok in enumerate(ev.su_crc_ok):
            if ok:
                disp.dispatch(ev.infofield[k * 12:(k + 1) * 12])


def test_station_mixed_rates():
    """600 and 1200 bps VFOs in one station (two bank groups)."""
    fs, center = 288000, 1545000000
    ini = (f"sample_rate={fs}\ncenter_frequency={center}\n[vfos]\nsize=2\n"
           f"1\\frequency=1545009000\n1\\data_rate=1200\n1\\topic=A\n1\\gain=100\n"
           f"2\\frequency=1545030000\n2\\data_rate=600\n2\\topic=B\n2\\gain=100\n")
    cfg = load_ini(ini, is_text=True)
    rng = np.random.default_rng(8)
    f1 = ti._acars_fields("MIXED RATE 1200", 0x111111)
    f2 = ti._acars_fields("MIXED RATE 600", 0x222222)
    s1 = ti._synth_msk_wb(build_p_frames(f1, 1200, lead_frames=3), fs,
                          1200.0, 1545009000 + 1000 - center)
    s2 = ti._synth_msk_wb(build_p_frames(f2, 600, lead_frames=3), fs, 600.0,
                          1545030000 + 1000 - center)
    n = max(len(s1), len(s2)) + 4 * fs
    wb = np.zeros(n, np.complex64)
    wb[: len(s1)] += s1
    wb[: len(s2)] += s2
    wb += (rng.normal(0, 0.004, n)
           + 1j * rng.normal(0, 0.004, n)).astype(np.complex64)
    got = {}
    st = Station(cfg, device="cpu",
                 on_acars=lambda t, item: got.setdefault(t, item.message))
    B = cfg.buflen_complex
    for i in range(len(wb) // B):
        st.process(wb[i * B:(i + 1) * B])
    assert got == {"A": "MIXED RATE 1200", "B": "MIXED RATE 600"}


def test_dropout_and_relock_long():
    """Signal -> silence -> different CFO -> signal again; both halves
    decode."""
    rng = np.random.default_rng(9)
    a1 = msk_modulate(build_p_frames(ti._acars_fields("BEFORE DROP",
                                                      0x0A0A0A), 1200,
                                     lead_frames=4), 24000, 1200, freq=1000.0)
    a2 = msk_modulate(build_p_frames(ti._acars_fields("AFTER RELOCK",
                                                      0x0B0B0B), 1200,
                                     lead_frames=4), 24000, 1200, freq=1180.0)
    sig = np.concatenate([a1, np.zeros(48000, np.float32), a2,
                          np.zeros(48000, np.float32)])
    p = np.mean(a1 ** 2)
    sig = (sig + rng.normal(0, np.sqrt(p / 10 ** 1.2), len(sig))
           ).astype(np.float32)
    msgs = []
    _dispatch(MskDemodulator(24000, 1200, device="cpu").process(sig),
              lambda it: msgs.append(it.message))
    assert "BEFORE DROP" in msgs
    assert "AFTER RELOCK" in msgs


EXPECTED_FIXTURE = {
    "reg": "N7REG", "label": "H1",
    "msg_text": "REGRESSION FIXTURE PAYLOAD 0123456789",
    "src": "ABC123",
}


def test_regression_fixture_jsondump():
    """Deterministic capture -> exact jsondump fields, through every layer
    of the port (modulator, demod, framing, SU dispatch, ACARS parse,
    output)."""
    rng = np.random.default_rng(1234)
    ud = make_acars_userdata("2", "N7REG", "!", "H1", "A",
                             EXPECTED_FIXTURE["msg_text"])
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0xABC123, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
    audio = msk_modulate(build_p_frames(fields, 1200, lead_frames=4),
                         24000, 1200, freq=1077.0)
    p = np.mean(audio ** 2)
    audio = (audio + rng.normal(0, np.sqrt(p / 10 ** 1.5), len(audio))
             ).astype(np.float32)
    items = []
    _dispatch(MskDemodulator(24000, 1200, device="cpu").process(
        np.concatenate([audio, np.zeros(32000, np.float32)])), items.append)
    assert len(items) == 1
    j = json.loads(to_output_format("jsondump", "FIXTURE", False, items[0],
                                    now=1700000000.0))
    acars = j["isu"]["acars"]
    assert acars["reg"] == EXPECTED_FIXTURE["reg"]
    assert acars["label"] == EXPECTED_FIXTURE["label"]
    assert acars["msg_text"] == EXPECTED_FIXTURE["msg_text"]
    assert j["isu"]["dst"]["addr"] == EXPECTED_FIXTURE["src"]


def test_fused_everything_at_once_with_restart(tmp_path):
    """One FusedStation with batched host framing and hunting on a mixed
    stream, restored from a checkpoint halfway: every message decodes
    across the restart, and the hunter's state survives it."""
    got, tel = ti.fused_soak("cpu", str(tmp_path))
    texts = {m for _, m in got}
    for text in ti.SOAK_TEXTS:
        assert text in texts, sorted(texts)
    assert abs(tel["OFF"]["freq"] - 2500.0) < 200.0, tel["OFF"]
    assert tel["BR"]["packets"] >= 1
