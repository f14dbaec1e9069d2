"""The small fused-station bank shared by the port's station tests.

The bank of tests/test_batch_framing.py (288 kS/s wideband, two 1200 bps
MSK VFOs carrying ACARS) plus an empty 600 bps VFO that hunts, so two rate
groups and two filterbank passes (K=24 and K=48) run per block.
"""

import numpy as np
from scipy.signal import firwin, lfilter

from aero_tpu_torch.models.msk import msk_modulate
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import build_p_frames
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu

FS, CENTER = 288000, 1545000000
INI = (f"[General]\nsample_rate={FS}\ncenter_frequency={CENTER}\n"
       "[vfos]\nsize=3\n"
       f"1\\frequency={CENTER + 24000}\n1\\data_rate=1200\n1\\topic=X\n"
       f"2\\frequency={CENTER - 24000}\n2\\data_rate=1200\n2\\topic=Y\n"
       f"3\\frequency={CENTER + 61000}\n3\\data_rate=600\n3\\topic=Z\n")


def p_stream(tag, delta, dur):
    ud = make_acars_userdata("2", "N" + tag, "!", "H1", "A", f"BATCH {tag}")
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0x345678, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
    audio = msk_modulate(build_p_frames(fields, 1200, lead_frames=3),
                         24000, 1200.0, freq=1000.0)
    up = FS // 24000
    x = np.zeros(len(audio) * up, np.float32)
    x[::up] = audio * up
    bb = lfilter(firwin(511, 1.0 / up), 1.0, x).astype(np.complex64)
    t = np.arange(len(bb)) / FS
    w = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)
    return np.concatenate([w, np.zeros(dur - len(w), np.complex64)])


def make_wideband():
    rng = np.random.default_rng(5)
    dur = 8 * FS
    wb = p_stream("XX", 24000, dur) + p_stream("YY", -24000, dur)
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)
    return wb
