"""A synthetic capture for the repo's 54W station file,
configs/aor_w_54_lband.ini, used unmodified: 1.536 MS/s around
1545.2 MHz, one main VFO (WB54, 192 kS/s), 24 P-channel subs under it on
a 2.5 kHz raster (600 and 1200 bps) and two burst R watchers (RCH01,
RCH02) taken straight from the wideband at 24 kS/s; 384,000-sample
blocks.

ACARS is planted on four subs (one 600 bps, three 1200 bps) and one R
burst on RCH01, in complex Gaussian noise.  Each P signal is analytic
(one sideband, so no image falls into a neighbour on the raster) at
+1000 Hz from its VFO, the demodulators' starting centre; fill frames
keep each carrier up to the end of the capture.  The 600 bps message
needs the longest: about 6 s of air time.  Shared by the CPU parity
tests and the chip smoke; imports no JAX.

The R burst's level is a workaround, not real traffic: it is planted 30
times (29.5 dB) stronger than the P signals.  At the file's default sub
gain (0.01) the watcher's audio lies far below full scale, and there the
burst window demodulator (JAX's and the port's alike) finds the burst
window but decodes no packet until the burst is about 1.5 times the P
signals' amplitude, so the file's watchers miss R bursts at the level of
its P channels.  ``tools/l54_burst_level.py`` sweeps the amplitude.
"""

import os

import numpy as np
from scipy.signal import hilbert, resample_poly

from aero_tpu_torch.models.msk import msk_modulate
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import build_p_frames
from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu_torch.protocol.rt_framing import build_r_burst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI_PATH = os.path.join(ROOT, "configs", "aor_w_54_lband.ini")
FS = 1536000
CENTER = 1545200000
BLOCK = 384000
# the capture: 32 blocks (8 s), the checkpoint split after 16
N_BLOCKS = 32
SPLIT = 16
# topic -> (RF Hz, bit rate, registration, messages)
CONTENT = {
    "VFO01": (1545095000, 600, "VH-SIX", ("L54 SIX HUNDRED",)),
    "VFO10": (1545125000, 1200, "N54TEN", ("L54 TEN ONE", "L54 TEN TWO")),
    "VFO20": (1545150000, 1200, "G-LTWO", ("L54 TWENTY ONE",
                                           "L54 TWENTY TWO")),
    "VFO24": (1545165000, 1200, "C-FTWF", ("L54 TWENTYFOUR ONE",
                                           "L54 TWENTYFOUR TWO")),
}
R_TOPIC = "RCH01"
R_FREQ = 1545390000
R_INFO = (bytes([0x1B, 0x28, 0x0A, 0x0B, 0x0C, 0x54]) + b"L54 R"
          ).ljust(17, b"\0")
R_START_S = 5.0
# the R burst's amplitude, against 1.0 for the P signals (see above)
R_AMPLITUDE = 30.0
AUDIO_FS = 24000


def _to_wideband(audio, rate, delta, n, start=0):
    """Real audio at ``rate`` -> its analytic (upper-sideband) form at
    FS, shifted by ``delta`` Hz, as n complex samples from ``start``."""
    up = FS // rate
    bb = resample_poly(hilbert(audio.astype(np.float64)), up, 1)
    bb = bb[: max(0, n - start)]
    t = (start + np.arange(len(bb))) / FS
    out = np.zeros(n, np.complex64)
    out[start: start + len(bb)] = bb * np.exp(2j * np.pi * delta * t)
    return out


def make_capture(n_blocks: int = N_BLOCKS, seed: int = 0,
                 r_amplitude: float = R_AMPLITUDE) -> np.ndarray:
    """The complex64 wideband capture, n_blocks * BLOCK samples."""
    n = n_blocks * BLOCK
    rng = np.random.default_rng(seed)
    wide = (0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    for k, (topic, (rf, rate, reg, texts)) in enumerate(CONTENT.items()):
        fields = []
        for text in texts:
            ud = make_acars_userdata("2", reg, "!", "H1", "A", text)
            sus = [append_crc16_bytes(b)
                   for b in segment_isu(ud, 0x540000 + k, 0x41)]
            assert len(sus) <= 6
            fields.append(b"".join(sus + [fill] * (6 - len(sus))))
        fields += [fill * 6] * (n * rate // (1200 * FS) + 1)
        fs_audio = {600: 12000, 1200: 24000}[rate]
        audio = msk_modulate(build_p_frames(fields, rate, lead_frames=3),
                             fs_audio, float(rate), freq=1000.0,
                             amplitude=1.0)
        wide += _to_wideband(audio, fs_audio, rf - CENTER, n)
    wide += r_burst(n, r_amplitude)
    return wide


def r_burst(n: int, amplitude: float = R_AMPLITUDE) -> np.ndarray:
    """The capture's R burst alone, as n complex samples: at RCH01's
    audio centre (24 kS/s / 4) + 40 Hz, from R_START_S.  The file's
    default sub gain (0.01) scales the watcher's audio by 1/100."""
    audio = msk_modulate(build_r_burst(R_INFO, preamble_bits=96), AUDIO_FS,
                         1200.0, freq=6040.0, amplitude=amplitude)
    return _to_wideband(audio, AUDIO_FS, R_FREQ - CENTER, n,
                        start=int(R_START_S * FS))


def planted():
    """Every (topic, ACARS text) the capture carries."""
    return {(t, m) for t, (_, _, _, texts) in CONTENT.items() for m in texts}
