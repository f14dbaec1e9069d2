"""R/T-channel burst framing: UW sync, checkpoint decoding, SU dispatch.

Behavioral equivalent of the reference's burst path: AeroL::Decode burstmode
(ref: decode/aerol.cpp:1080-1474) + RTChannelDeleaveFECScram
(ref: decode/aerol.h:548-850):

- a -1 marker in the soft stream marks start-of-burst (demodulator inserts
  it; ref burstmskdemodulator.cpp:503-505)
- 32-bit UW 3780831379 decimal = 0xE15AE893, phase-invariant with tolerance 4
  (ref: aerol.cpp:960-977 burst tolerances)
- after the UW, soft bits accumulate into 64-bit rows; decode attempts run
  at checkpoints: MSK layout at 5/11/target/50 rows (aerol.h:630-634),
  OQPSK at every 5+3k rows (aerol.h:762)
- each attempt: deinterleave (burst-MSK or straight layout) -> soft Viterbi
  -> descramble -> CRC tests: R packet = 19 bytes checked over 152 bits;
  T packet = 6-byte header + 12-byte SUs (aerol.h:653-738)
- R SUs route through RISUData, T SUs through ISUData -> ParserISU
  (ref: aerol.cpp:1254-1468)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from aero_tpu_torch.protocol.crc import crc16_check_bits
from aero_tpu_torch.protocol.scrambler import scramble_bits
from aero_tpu_torch.protocol.interleaver import (deinterleave_indices,
                                           deinterleave_msk_burst_indices)
# the checkpoint decoder is injected (``decoder``): the fused station
# passes one that runs the CUDA Viterbi kernel on its device
from aero_tpu_torch.ops.viterbi_kernel import stream_decoder
from aero_tpu_torch.protocol.framing import UW_BITS, bits_to_bytes_lsb
from aero_tpu_torch.protocol.isu import ISUData, RISUData
from aero_tpu_torch.protocol.acars import ParserISU

MAX_ROWS = 95           # ref: aerol.h:564 block.resize(64*95)

R_MESSAGE_NAMES = {
    0x20: "General_access_request_telephone",
    0x23: "Abbreviated_access_request_telephone",
    0x22: "Access_request_data_R_T_channel",
    0x61: "Request_for_acknowledgement_R_channel",
    0x62: "Acknowledgement_R_channel",
    0x12: "Log_On_Off_control_R_channel",
    0x30: "Call_progress_R_channel",
    0x15: "Log_On_Off_acknowledgement",
    0x17: "Log_control_R_channel_ready_for_reassignment",
    0x60: "Telephony_acknowledge_R_channel",
}


@dataclass
class RTPacketEvent:
    kind: str                  # 'R' or 'T'
    infofield: bytes
    n_sus: int = 0
    display: str = ""


class RTChannelFramer:
    """Consumes a marked int16 soft stream (-1 burst start, -2 masked,
    0..255 soft) and emits decoded R/T packets + ACARS via callbacks."""

    def __init__(self, oqpsk: bool = False,
                 on_acars: Callable | None = None,
                 on_fragment: Callable | None = None,
                 on_error: Callable | None = None,
                 uw_tolerance: int = 4,
                 db=None, decoder=None):
        self.oqpsk = oqpsk
        # soft [2T] -> bits [T]; default: the plain twin on the CPU
        self.decoder = decoder or stream_decoder("cpu")
        self.uw_tolerance = uw_tolerance
        self.risudata = RISUData()
        self.isudata = ISUData()
        self.parser = ParserISU(on_acars, on_fragment, on_error, db=db)
        self.parser.downlink = True
        self._reset_burst()
        self.events: list[RTPacketEvent] = []

    def _reset_burst(self):
        self._collect = np.zeros(0, np.float32)
        self._synced = False
        self._done = False
        self._target_su = 0
        self._target_rows = 0
        self._flip_pattern = np.zeros(32, np.int32)
        self._tried = set()

    # ---- stream interface ----

    def feed(self, soft16: np.ndarray) -> list[RTPacketEvent]:
        """soft16: int16 array (soft 0..255, -1 burst start, -2 masked)."""
        events = []
        soft16 = np.asarray(soft16)
        # split on burst markers; process each segment
        starts = np.flatnonzero(soft16 == -1)
        segments = np.split(soft16, starts) if starts.size else [soft16]
        for gi, seg in enumerate(segments):
            if gi > 0:
                self._reset_burst()
                seg = seg[1:]              # drop the marker itself
            seg = seg[seg >= 0].astype(np.float32)
            if seg.size == 0:
                continue
            events.extend(self._feed_burst(seg))
        self.events.extend(events)
        return events

    def _feed_burst(self, soft: np.ndarray) -> list[RTPacketEvent]:
        if self._done:
            return []
        self._collect = np.concatenate([self._collect, soft])
        if not self._synced:
            hard = (self._collect >= 128).astype(np.int32)
            if len(hard) < 32:
                return []
            w = np.lib.stride_tricks.sliding_window_view(hard, 32)
            # 4 polarity hypotheses: a 90-degree-family carrier lock can flip
            # one arm only (alternating inversion); the reference resolves
            # this with its "twospeed" x4-PLL phase logic
            # (burstoqpskdemodulator.cpp:569-586) — here it falls out of the
            # UW match itself.
            alt = (np.arange(32) % 2).astype(np.int32)
            patterns = [np.zeros(32, np.int32), np.ones(32, np.int32),
                        alt, 1 - alt]
            best = None
            for pi, flip in enumerate(patterns):
                errs = np.sum(w != (UW_BITS ^ flip)[None, :], axis=1)
                hits = np.flatnonzero(errs <= self.uw_tolerance)
                if hits.size and (best is None or hits[0] < best[1]):
                    best = (pi, int(hits[0]))
            if best is None:
                if len(self._collect) > 4096:
                    self._done = True
                return []
            pi, start = best
            self._flip_pattern = patterns[pi]
            self._collect = self._collect[start + 32:]
            self._synced = True
        # payload bit j sits at window-parity (32+j) % 2 == j % 2, so the
        # per-arm flip pattern applies by stream index parity
        flips = self._flip_pattern[np.arange(len(self._collect)) % 2]
        data = np.where(flips > 0, 255.0 - self._collect, self._collect)
        return self._try_checkpoints(data)

    # ---- checkpoint decoding ----

    def _is_checkpoint(self, rows: int) -> bool:
        if (rows * 64 - 320) % 192 != 0:
            return False
        if self.oqpsk:
            return True
        return rows in (5, 11, 50) or (self._target_rows > 0
                                       and rows == self._target_rows)

    def _try_checkpoints(self, data: np.ndarray) -> list[RTPacketEvent]:
        events = []
        avail = min(len(data) // 64, MAX_ROWS)
        for rows in range(5, avail + 1):
            if self._done:
                break
            if not self._is_checkpoint(rows) or rows in getattr(self, "_tried", set()):
                continue
            self._tried = getattr(self, "_tried", set())
            self._tried.add(rows)

            block = data[: rows * 64]
            idx = (deinterleave_indices(rows) if self.oqpsk
                   else deinterleave_msk_burst_indices(rows))
            bits = np.asarray(self.decoder(block[idx]))
            bits = scramble_bits(bits)

            if rows == 5:
                if crc16_check_bits(bits[: 8 * 19]):
                    info = bits_to_bytes_lsb(bits[: 8 * 19])
                    events.append(self._emit_r(info))
                    self._done = True
                continue

            # T packet: header CRC over 6 bytes
            if not crc16_check_bits(bits[: 8 * 6]):
                continue
            nbytes = (len(bits) // 8) * 8
            if not self.oqpsk:
                if rows == 11 and self._target_su == 0:
                    isu = bits[48 + 96: 48 + 96 + 6]
                    size = 2 + int(np.sum(isu * (1 << np.arange(6))))
                    if size >= 16:
                        size = size // 2 + 1
                    self._target_su = size
                    self._target_rows = (size + 1) * 3 + 2
                    continue
                if self._target_rows and rows == self._target_rows:
                    n_sus = self._target_su
                    ok = sum(crc16_check_bits(bits[48 + 96 * i: 48 + 96 * (i + 1)])
                             for i in range(max(0, n_sus - 3)))
                    if ok <= n_sus:   # ref's lenient acceptance (aerol.h:727)
                        events.append(self._emit_t(
                            bits_to_bytes_lsb(bits[:nbytes]), n_sus))
                        self._done = True
                continue
            # OQPSK: all SU CRCs must pass (aerol.h:810-823)
            n_sus = 1 + (rows * 64 - 320) // 192
            if all(crc16_check_bits(bits[48 + 96 * i: 48 + 96 * (i + 1)])
                   for i in range(n_sus)):
                events.append(self._emit_t(bits_to_bytes_lsb(bits[:nbytes]),
                                           n_sus))
                self._done = True
        return events

    # ---- SU dispatch ----

    def _emit_r(self, info: bytes) -> RTPacketEvent:
        """R packet (19 bytes) dispatch (ref: aerol.cpp:1254-1397)."""
        message = info[2]
        if info[1] & 0x08:
            name = "User_data_ISU_SSU_R_channel"
            if (done := self.risudata.update(info[:17])) is not None:
                self.parser.downlink = True
                self.parser.parse(done)
        else:
            name = R_MESSAGE_NAMES.get(message, f"0x{message:02X}")
        hexpart = " ".join(f"0x{b:02X}" for b in info[:17])
        return RTPacketEvent("R", info, 0, f"{hexpart} {name}")

    def _emit_t(self, info: bytes, n_sus: int) -> RTPacketEvent:
        """T packet dispatch (ref: aerol.cpp:1400-1468)."""
        aesid = info[0] << 16 | info[1] << 8 | info[2]
        ges = info[3]
        lines = [f"T Packet from AES: {aesid:06X} to GES: {ges:02X} "
                 f"with {n_sus} SUs"]
        for k in range(n_sus):
            su = info[6 + k * 12: 6 + k * 12 + 12]
            if len(su) < 10:
                break
            message = su[0]
            if message == 0x01:
                lines.append("Fill_in_signal_unit")
            elif message == 0x71:
                lines.append("User_data_ISU_RLS_T_channel")
                self.isudata.update(su[:10])
            elif (message & 0xC0) == 0xC0:
                lines.append("User_data_ISU_SSU_T_channel")
                if (done := self.isudata.update(su[:10])) is not None:
                    self.parser.downlink = True
                    self.parser.parse(done)
        return RTPacketEvent("T", info, n_sus, "\n".join(lines))


# ---------------------------------------------------------------------------
# TX-side burst builders (for synthetic test vectors)
# ---------------------------------------------------------------------------

def _encode_burst_payload(info_bits: np.ndarray, rows: int,
                          oqpsk: bool) -> np.ndarray:
    from aero_tpu_torch.protocol.viterbi import conv_encode
    from aero_tpu_torch.protocol.interleaver import deinterleave_msk_burst_indices
    assert len(info_bits) == rows * 32
    coded = conv_encode(scramble_bits(info_bits))
    if oqpsk:
        idx = deinterleave_indices(rows)
    else:
        idx = deinterleave_msk_burst_indices(rows)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(len(idx))
    return coded[inv]


def build_r_burst(info17: bytes, oqpsk: bool = False,
                  preamble_bits: int = 64) -> np.ndarray:
    """R packet: 17 info bytes + CRC -> 5 rows; returns the burst bit stream
    [preamble][UW][interleaved coded]."""
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    assert len(info17) == 17
    pkt = append_crc16_bytes(info17)              # 19 bytes = 152 bits
    bits = np.unpackbits(np.frombuffer(pkt, np.uint8), bitorder="little")
    info = np.concatenate([bits, np.zeros(8, np.uint8)])  # pad to 160
    payload = _encode_burst_payload(info, 5, oqpsk)
    pre = (np.arange(preamble_bits) % 2).astype(np.uint8)
    return np.concatenate([pre, UW_BITS, payload])


def build_t_burst(aesid: int, gesid: int, sus: list, oqpsk: bool = False,
                  preamble_bits: int = 64) -> np.ndarray:
    """T packet: 4-byte header + CRC, then 12-byte SUs (10 bytes + CRC)."""
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    n_sus = len(sus)
    # MSK T packets carry (N+1)*3+2 rows (ref targetBlocks, aerol.h:703);
    # OQPSK T packets are read back as N = 1+(rows*64-320)/192
    # (aerol.h:811), i.e. 3N+2 rows
    rows = (n_sus + 1) * 3 + 2 if not oqpsk else 3 * n_sus + 2
    header = append_crc16_bytes(bytes(
        [(aesid >> 16) & 0xFF, (aesid >> 8) & 0xFF, aesid & 0xFF, gesid]))
    body = b"".join(append_crc16_bytes(bytes(su[:10])) for su in sus)
    info = header + body
    info_bits = np.unpackbits(np.frombuffer(info, np.uint8),
                              bitorder="little")
    total = rows * 32
    info_bits = np.concatenate(
        [info_bits, np.zeros(total - len(info_bits), np.uint8)])
    payload = _encode_burst_payload(info_bits, rows, oqpsk)
    pre = (np.arange(preamble_bits) % 2).astype(np.uint8)
    return np.concatenate([pre, UW_BITS, payload])
