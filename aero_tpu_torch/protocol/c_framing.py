"""C-channel framing (8400 bps OQPSK): voice frames + sub-band signalling.

Behavioral equivalent of AeroL::DecodeC (ref: decode/aerol.cpp:2145-2430):

- frame = 4096 soft bits + dual 52-bit UWs carried on the two OQPSK arms
  (I 0xAB376938BCA30 / Q 0xC53D1C96ECD5, interleaved bit-by-bit;
  ref: aerol.cpp:921-928), total 4200 bits = 0.5 s
- per 256 soft bits: 64x4 deinterleave (aerol.cpp:2239-2247)
- at frame end: depuncture pattern 4 -> continuous Viterbi -> 2714 bits ->
  descramble (aerol.cpp:2249-2266)
- layout: 25 groups of [96 voice bits], the first 24 followed by 12
  signalling bits + 1 pad (aerol.cpp:2273-2417); signalling bits build
  12-byte SUs (3 per frame) with CRC-16; voice packs to 300 bytes -> 25
  12-byte codec frames
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from aero_tpu_torch.protocol.crc import crc16_bytes
from aero_tpu_torch.protocol.scrambler import scramble_bits
from aero_tpu_torch.protocol.interleaver import (deinterleave_indices,
                                           interleave_indices,
                                           depuncture_soft, puncture_soft)
from aero_tpu_torch.protocol.viterbi import StreamingViterbi
from aero_tpu_torch.protocol.framing import bits_to_bytes_lsb, bytes_to_bits_lsb

UW_I = 0xAB376938BCA30        # 52 bits (ref: aerol.cpp:922-925)
UW_Q = 0xC53D1C96ECD5

C_MESSAGE_NAMES = {
    0x01: "Fill_in_signal_unit",
    0x30: "Call_progress",
    0x60: "Telephony_acknowledge",
}

FRAME_BITS = 4096
INFO_BITS = 2714
GROUP = 109                   # 1 pad + 96 voice + 12 signalling


def _uw_bits(val: int, n: int = 52) -> np.ndarray:
    return np.array([(val >> i) & 1 for i in range(n - 1, -1, -1)], np.uint8)


# interleaved dual UW as transmitted: Q-arm bit then I-arm bit per pair
# (the RX stream alternates arms starting with the imag/Q sample)
UW_PAIR = np.empty(104, dtype=np.uint8)
UW_PAIR[0::2] = _uw_bits(UW_Q)
UW_PAIR[1::2] = _uw_bits(UW_I)


@dataclass
class CFrameEvent:
    frame_index: int
    signalling: list           # [(su_bytes, crc_ok, name)]
    voice: bytes               # 300 bytes = 25 x 12-byte codec frames
    uw_errors: int


class CChannelFramer:
    """Soft bytes in -> C-channel frames out (signalling + voice)."""

    def __init__(self, on_voice: Callable | None = None,
                 on_call_progress: Callable | None = None,
                 uw_tolerance: int = 6):
        self.on_voice = on_voice or (lambda data, hex_aes: None)
        self.on_call_progress = on_call_progress or (lambda su: None)
        self.uw_tolerance = uw_tolerance
        self.viterbi = StreamingViterbi()
        self.buf = np.zeros(0, np.float32)
        self.locked = False
        self.frame_index = 0
        self._flip = np.zeros(2, np.int32)
        self._hex = "000000"

    def _correlate(self, hard: np.ndarray):
        """Per-arm polarity-invariant correlation against the interleaved
        dual UW (ref dual OQPSKPreambleDetectorAndAmbiguityCorrection,
        aerol.cpp:783-869).  Arm roles may be swapped by timing parity, so
        both pairings are tried."""
        n = 104
        if len(hard) < n:
            return None
        w = np.lib.stride_tricks.sliding_window_view(hard.astype(np.int32), n)
        best = None
        for swap in (0, 1):
            pat = np.empty(104, np.int32)
            if swap:
                pat[0::2] = _uw_bits(UW_I)
                pat[1::2] = _uw_bits(UW_Q)
            else:
                pat = UW_PAIR.astype(np.int32)
            e0 = np.sum(w[:, 0::2] != pat[0::2][None, :], axis=1)
            e1 = np.sum(w[:, 1::2] != pat[1::2][None, :], axis=1)
            errs = np.minimum(e0, 52 - e0) + np.minimum(e1, 52 - e1)
            hits = np.flatnonzero(errs <= self.uw_tolerance)
            if hits.size and (best is None or hits[0] < best[0]):
                f0 = 1 if e0[hits[0]] > 26 else 0
                f1 = 1 if e1[hits[0]] > 26 else 0
                best = (int(hits[0]), np.array([f0, f1], np.int32))
        return best

    def feed(self, soft_bytes: np.ndarray,
             slip: int = 0) -> list[CFrameEvent]:
        """Feed one demod block; ``slip`` realigns a timing-grid
        renormalization at the framer boundary (see PChannelFramer.feed)."""
        from aero_tpu_torch.protocol.framing import apply_slip
        self.buf = np.concatenate([self.buf,
                                   apply_slip(soft_bytes, slip)])
        events = []
        while True:
            if not self.locked:
                hard = (self.buf >= 128).astype(np.uint8)
                found = self._correlate(hard)
                if found is None:
                    if len(self.buf) > 2 * (FRAME_BITS + 104):
                        self.buf = self.buf[-(104):]
                    return events
                start, self._flip = found
                self.buf = self.buf[start + 104:]
                self.locked = True
                self.viterbi.reset()
                self.frame_index = 0
                continue
            total = FRAME_BITS + 104
            if len(self.buf) < total:
                return events
            frame = self.buf[:total]
            self.buf = self.buf[total:]
            events.append(self._decode_frame(frame))
        return events

    def _decode_frame(self, frame: np.ndarray) -> CFrameEvent:
        flips = self._flip[np.arange(len(frame)) % 2]
        frame = np.where(flips > 0, 255.0 - frame, frame)
        payload = frame[:FRAME_BITS]
        uw = (frame[FRAME_BITS:] >= 128).astype(np.int32)
        e0 = int(np.sum(uw[0::2] != UW_PAIR[0::2]))
        e1 = int(np.sum(uw[1::2] != UW_PAIR[1::2]))
        uw_errors = min(e0, 52 - e0) + min(e1, 52 - e1)
        if uw_errors > self.uw_tolerance + 4:
            self.locked = False

        didx = deinterleave_indices(4)
        soft = np.concatenate([payload[i * 256:(i + 1) * 256][didx]
                               for i in range(FRAME_BITS // 256)])
        depunct = depuncture_soft(soft, 4)
        bits = self.viterbi.decode(depunct)[:INFO_BITS]
        bits = scramble_bits(bits, 0)

        # 12 signalling bits per group accumulate into 12-byte SUs (3/frame)
        signalling = []
        sig_bits = np.concatenate([bits[y * GROUP + 97: y * GROUP + 109]
                                   for y in range(24)])
        for k in range(3):
            su = bits_to_bytes_lsb(sig_bits[k * 96:(k + 1) * 96])
            crc_ok = crc16_bytes(su[:10]) == (su[11] << 8 | su[10])
            name = C_MESSAGE_NAMES.get(su[0], "Other") if crc_ok else ""
            if crc_ok and su[0] == 0x30:
                self.on_call_progress(su)
                self._hex = su[1:4].hex().upper()
            signalling.append((su, crc_ok, name))

        voice_groups = [bits[y * GROUP + 1: y * GROUP + 97] for y in range(25)]
        voice = bits_to_bytes_lsb(np.concatenate(voice_groups))
        self.on_voice(voice, self._hex)

        ev = CFrameEvent(self.frame_index, signalling, voice, uw_errors)
        self.frame_index += 1
        return ev


# ---------------------------------------------------------------------------
# TX builder (synthetic test vectors)
# ---------------------------------------------------------------------------

def build_c_frames(frames: list, lead_frames: int = 2) -> np.ndarray:
    """frames: list of (signalling_sus [3 x 12 bytes], voice [300 bytes]).

    Returns the C-channel bit stream.  Like the P channel, the decoded
    payload of frame k is parsed when frame k completes, so payloads are
    shifted by one frame on TX (continuous conv encoding throughout).
    """
    msgs = []
    for sus, voice in frames:
        assert len(sus) == 3 and all(len(s) == 12 for s in sus)
        assert len(voice) == 300
        bits = np.zeros(INFO_BITS, np.uint8)
        vb = bytes_to_bits_lsb(bytes(voice))
        sb = np.concatenate([bytes_to_bits_lsb(bytes(s)) for s in sus])
        for y in range(25):
            bits[y * GROUP + 1: y * GROUP + 97] = vb[y * 96:(y + 1) * 96]
        for y in range(24):
            bits[y * GROUP + 97: y * GROUP + 109] = sb[y * 12:(y + 1) * 12]
        msgs.append(bits)

    n_frames = lead_frames + len(msgs) + 1
    payloads = []
    for j in range(n_frames):
        k = j - lead_frames
        payloads.append(msgs[k] if 0 <= k < len(msgs)
                        else np.zeros(INFO_BITS, np.uint8))

    # continuous conv encoding over scrambled per-frame payloads + tail pad
    stream = []
    iidx = interleave_indices(4)
    from aero_tpu_torch.protocol.viterbi import POLYS, _parity
    reg = 0
    for j in range(n_frames):
        info = np.concatenate([scramble_bits(payloads[j]),
                               np.zeros(2730 - INFO_BITS, np.uint8)])
        coded = np.empty(2 * len(info), np.uint8)
        for i, b in enumerate(info):
            reg = ((reg << 1) | int(b)) & 0x7F
            coded[2 * i] = _parity(np.uint32(reg & POLYS[0]))
            coded[2 * i + 1] = _parity(np.uint32(reg & POLYS[1]))
        punct = np.append(puncture_soft(coded, 4), 0).astype(np.uint8)
        assert len(punct) == FRAME_BITS
        inter = np.concatenate([punct[i * 256:(i + 1) * 256][iidx]
                                for i in range(FRAME_BITS // 256)])
        stream.append(inter)
        stream.append(UW_PAIR)
    return np.concatenate(stream)
