"""Aero-L P-channel framing: TX frame builder and RX deframer.

Frame layout (ref: decode/aerol.cpp:960-1039 setSettings, 1060-2038 Decode):

  rate   header      coded payload     UW                total    duration
  600    16 bits     1152 soft bits    32 bits           1200     2 s
  1200   16 bits     1152 soft bits    32 bits           1200     1 s
  10500  16+178      4992 soft bits    64 bits (2x32)    5250     0.5 s

- UW 3780831379 decimal = 0xE15AE893 (32 bits, MSB first; aerol.cpp:918-919).
  At 10500 the
  stream alternates imag/real OQPSK arms and each arm carries the same 32-bit
  UW, i.e. each UW bit appears twice in a row (aerol.cpp:1089-1152).
- Payload: 64xN interleaved blocks (N=6/9/78) of a *continuous* K=7 r=1/2
  convolutional stream; the information bits are scrambled with the LFSR
  keystream restarted at every frame (aerol.cpp:1496-1520, 2014).
- Alignment: the reference's Decode_Continuous trim (+25 bits,
  jconvolutionalcodec.cpp:190-191) and 570-bit delay line (aerol.cpp:983)
  compose to exactly one full frame of delay, so the infofield displayed for
  frame k is the decoded payload of frame k-1.  Here the deframer parses each
  frame's payload as soon as it decodes — same content, one frame earlier.
- SUs: infofield splits into 12-byte signal units, CRC-16 checked
  (aerol.cpp:1531-1543); DCD hysteresis +2 per good SU / -3 per bad, on at
  >2, capped 12 (aerol.cpp:1546-1556).

A copy of ``aero_tpu/protocol/framing.py`` but for one repair: an OQPSK
framer (arm-duplicated UW) reads each arm's polarity from the UW in front
of every frame, not only from the UW it locked on
(``PChannelFramer._rederive_arm_flip``).  The reference keeps the lock's
polarity while the lock lasts, so an arm that flips under a held lock
fails every SU's CRC from then on.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from aero_tpu_torch.protocol.crc import crc16_bytes
from aero_tpu_torch.protocol.scrambler import scramble_bits
from aero_tpu_torch.protocol.interleaver import (deinterleave_indices,
                                           interleave_indices)
from aero_tpu_torch.protocol.viterbi import conv_encode, StreamingViterbi

# The reference writes the preamble as DECIMAL 3780831379 (ref:
# aerol.cpp:918-919 "3780831379LL ... 0b11100001010110101110100010010011"),
# i.e. 0xE15AE893 — NOT hex 0x3780831379.  Caught by the hand-built
# frame-vector oracle (tests/test_frame_vectors.py::test_uw_literals);
# before that fix TX and RX shared the wrong 0x80831379 pattern, so every
# internal round trip passed while a real signal would never lock.
UW = 3780831379  # decimal == 0xE15AE893, 32 bits
UW_BITS = np.array([(UW >> i) & 1 for i in range(31, -1, -1)], dtype=np.uint8)


@dataclass(frozen=True)
class FrameSpec:
    rate: int
    cols: int              # interleaver columns per 64-row block
    blocks_per_frame: int
    header_bits: int       # counted header bits (frameinfo)
    dummy_bits: int        # uncounted dummy bits after header (10500 only)
    uw_repeat: int         # 1 = plain UW, 2 = each bit twice (OQPSK arms)

    @property
    def payload_soft_bits(self) -> int:
        return 64 * self.cols * self.blocks_per_frame

    @property
    def payload_info_bits(self) -> int:
        return self.payload_soft_bits // 2

    @property
    def uw_bits(self) -> int:
        return 32 * self.uw_repeat

    @property
    def total_bits(self) -> int:
        return (self.header_bits + self.dummy_bits + self.payload_soft_bits
                + self.uw_bits)


FRAME_SPECS = {
    600: FrameSpec(600, 6, 3, 16, 0, 1),
    1200: FrameSpec(1200, 9, 2, 16, 0, 1),
    10500: FrameSpec(10500, 78, 1, 16, 178, 2),
}


def pack_frameinfo(formatid=1, supfrm=0, fc=0) -> np.ndarray:
    """16 header bits, MSB first (ref: aerol.cpp:1185-1233)."""
    val = ((formatid & 0xF) << 12) | ((supfrm & 0xF) << 8) | ((fc & 0xF) << 4) | (fc & 0xF)
    return np.array([(val >> i) & 1 for i in range(15, -1, -1)], dtype=np.uint8)


def bytes_to_bits_lsb(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8), bitorder="little")


def bits_to_bytes_lsb(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits.reshape(-1, 8)[:, ::-1], axis=1).tobytes()


def build_p_frames(infofields: list[bytes], rate: int,
                   lead_frames: int = 2) -> np.ndarray:
    """TX: build the P-channel bit stream carrying the given infofields.

    Each infofield is ``payload_info_bits/8`` bytes (e.g. 72 at 600/1200;
    12-byte SUs with CRCs already in place — see crc.append_crc16_bytes).
    ``lead_frames`` dummy frames precede the payload so the receiver can lock
    and warm its trellis.  Returns hard bits (uint8).
    """
    spec = FRAME_SPECS[rate]
    nbits = spec.payload_info_bits
    msgs = []
    for f in infofields:
        bits = bytes_to_bits_lsb(f)
        assert len(bits) == nbits, (len(bits), nbits)
        msgs.append(bits)

    # frame j's coded payload carries infofield j+1 (one-frame delay on RX);
    # lead frames carry fill, one trailing frame flushes the last message.
    n_frames = lead_frames + len(msgs) + 1
    payload_msgs = []
    for j in range(n_frames):
        k = j - lead_frames + 1  # infofield index this payload will carry
        if 0 <= k < len(msgs):
            payload_msgs.append(msgs[k])
        else:
            payload_msgs.append(np.zeros(nbits, dtype=np.uint8))

    # continuous convolutional encoding over scrambled segments
    scrambled = np.concatenate([scramble_bits(m) for m in payload_msgs])
    coded = conv_encode(scrambled)

    inter_idx = interleave_indices(spec.cols)
    blocklen = 64 * spec.cols
    out = []
    fc = 0
    for j in range(n_frames):
        seg = coded[j * spec.payload_soft_bits:(j + 1) * spec.payload_soft_bits]
        inter = np.concatenate(
            [seg[b * blocklen:(b + 1) * blocklen][inter_idx]
             for b in range(spec.blocks_per_frame)])
        hdr = pack_frameinfo(formatid=1, fc=fc)
        fc = (fc + 1) & 0xF
        dummy = np.zeros(spec.dummy_bits, dtype=np.uint8)
        uw = np.repeat(UW_BITS, spec.uw_repeat)
        out.append(np.concatenate([hdr, dummy, inter, uw]))
    return np.concatenate(out)


@dataclass
class FrameEvent:
    """One decoded P-channel frame."""
    frame_index: int
    infofield: bytes
    su_crc_ok: list
    frameinfo: int
    uw_errors: int


def apply_slip(soft: np.ndarray, slip: int) -> np.ndarray:
    """Realign one demod block's soft bits after a timing-grid
    renormalization (the demod's ``out["slip"]``).

    slip=+1: the grid wrapped up by one strobe interval — the stream
    skipped one bit pair; insert two neutral (128) soft bits so frame
    alignment downstream holds (two erasures out of a whole frame, which
    the Viterbi absorbs).  slip=-1: one bit pair was emitted twice; drop
    the duplicated leading pair.  The reference's per-sample timing NCO
    slews continuously and never slips; with this realignment the
    block-feedforward design matches that behavior at the frame level
    instead of losing one frame per renormalization."""
    if slip > 0:
        return np.concatenate(
            [np.full(2, 128.0, dtype=np.float32),
             np.asarray(soft, dtype=np.float32)])
    if slip < 0:
        return np.asarray(soft, dtype=np.float32)[2:]
    return np.asarray(soft, dtype=np.float32)


class PChannelFramer:
    """RX deframer for one VFO: soft bytes in, decoded frames out.

    Hard-bit UW correlation replaces the per-bit shift-register detector
    (ref: aerol.cpp:688-725); the rest of the pipeline (deinterleave ->
    streaming Viterbi -> descramble -> SU CRC) runs on whole frames.
    OQPSK arm inversion handling (phase-invariant detectors,
    aerol.cpp:1089-1152) is enabled with ``phase_invariant=True``: each
    arm's polarity is estimated from the UW match and soft bits are
    conditionally flipped per arm.  With an arm-duplicated UW (OQPSK
    10500) the polarity is read again from each frame's trailing UW for
    the frame after it, so a carrier that slips to another lock point
    while the framer stays locked costs at most the frame it slipped in.
    """

    def __init__(self, rate: int, phase_invariant: bool | None = None,
                 uw_tolerance: int = 2):
        self.spec = FRAME_SPECS[rate]
        # Polarity invariance is always on: the MSK carrier loop has
        # 90-degree-family lock points that complement the differentially
        # decoded stream, so UW detection must accept either polarity and
        # flip the soft bits (the reference only does this for OQPSK via its
        # phase-invariant detectors, aerol.cpp:727-780; doing it for MSK too
        # makes every lock quadrant decodable).
        self.phase_invariant = (True if phase_invariant is None
                                else phase_invariant)
        self.uw_tolerance = uw_tolerance
        self.viterbi = StreamingViterbi()
        self.buf = np.zeros(0, dtype=np.float32)
        self.locked = False
        self.frame_index = 0
        self.dcd_count = 0
        self.dcd = False
        self._uw_pattern = np.repeat(UW_BITS, self.spec.uw_repeat).astype(np.int32)
        self._arm_flip = np.zeros(self.spec.uw_repeat, dtype=bool)
        # deferred-decode mode (protocol/batch_framing.py): feed() queues
        # prepared frames instead of decoding; a bank decodes ALL pending
        # frames of many VFOs in one device call and replays the
        # bookkeeping via _finish_frame
        self.defer_decode = False
        self._pending: list = []
        self._lock_gen = 0     # bumped per (re)lock; guards deferred relock

    # ---- UW search ----

    def _correlate_uw(self, hard: np.ndarray) -> np.ndarray:
        """Number of UW bit errors ending at each position.

        Phase invariance is PER ARM when the UW is arm-duplicated
        (uw_repeat=2): a 90-degree carrier lock flips one OQPSK arm only,
        so each arm's polarity is scored independently (the reference's
        separate real/imag phase-invariant detectors, aerol.cpp:1089-1152).
        """
        n = len(self._uw_pattern)
        if len(hard) < n:
            return np.full(len(hard), 99, dtype=np.int32)
        windows = np.lib.stride_tricks.sliding_window_view(hard.astype(np.int32), n)
        r = self.spec.uw_repeat
        if self.phase_invariant:
            errs = np.zeros(windows.shape[0], dtype=np.int32)
            for arm in range(r):
                e = np.sum(windows[:, arm::r] != self._uw_pattern[None, arm::r],
                           axis=1)
                errs += np.minimum(e, n // r - e)
        else:
            errs = np.sum(windows != self._uw_pattern[None, :], axis=1)
        out = np.full(len(hard), 99, dtype=np.int32)
        out[n - 1:] = errs
        return out

    def feed(self, soft_bytes: np.ndarray, slip: int = 0) -> list[FrameEvent]:
        """Feed one demod block's soft bytes.  Pass the demod's
        ``out["slip"]`` so a timing-grid renormalization is realigned
        HERE, at the boundary every consumer must cross — forgetting it
        at a call site would silently reintroduce one lost frame per
        renormalization."""
        self.buf = np.concatenate(
            [self.buf, apply_slip(soft_bytes, slip)])
        events = []
        while True:
            if not self.locked:
                hard = (self.buf >= 128).astype(np.uint8)
                errs = self._correlate_uw(hard)
                tol = 0 if not self.phase_invariant else self.uw_tolerance
                hits = np.flatnonzero(errs <= tol)
                if hits.size == 0:
                    keep = self.spec.uw_bits
                    if len(self.buf) > keep:
                        self.buf = self.buf[-keep:]
                    return events
                end = int(hits[0])
                self._calibrate_arm_flip(hard, end)
                self.buf = self.buf[end + 1:]
                self.locked = True
                self._lock_gen += 1
                self.viterbi.reset()
                self.frame_index = 0
                continue
            # locked: need one whole frame
            total = self.spec.total_bits
            if len(self.buf) < total:
                return events
            frame = self.buf[:total]
            self.buf = self.buf[total:]
            events.extend(self._decode_frame(frame))
            if not self.locked:
                # lock lost on this frame's UW — a timing slip shifted
                # the boundary a few bits.  Re-expose the frame's
                # trailing UW region to the search: relock lands on the
                # SHIFTED UW instead of a whole frame later, so a slip
                # costs one frame, not two (measured under ±100 ppm
                # sample-clock offset).
                k = len(self._uw_pattern) + 16
                self.buf = np.concatenate([frame[-k:], self.buf])
        return events

    def _calibrate_arm_flip(self, hard: np.ndarray, end: int):
        """For phase-invariant (OQPSK) mode: decide per-arm inversion from
        the UW just found (ref 'inverted' flags, aerol.cpp:727-780)."""
        r = self.spec.uw_repeat
        if not self.phase_invariant:
            self._arm_flip = np.zeros(r, dtype=bool)
            return
        w = hard[end + 1 - len(self._uw_pattern): end + 1].astype(np.int32)
        flips = np.zeros(r, dtype=bool)
        for arm in range(r):
            seg = w[arm::r]
            pat = self._uw_pattern[arm::r]
            errs = int(np.sum(seg != pat))
            flips[arm] = errs > len(seg) // 2
        self._arm_flip = flips

    def _apply_arm_flip(self, soft: np.ndarray) -> np.ndarray:
        if not self._arm_flip.any():
            return soft
        out = soft.copy()
        r = self.spec.uw_repeat
        for arm in range(r):
            if self._arm_flip[arm]:
                out[arm::r] = 255.0 - out[arm::r]
        return out

    def _decode_frame(self, frame: np.ndarray) -> list[FrameEvent]:
        pre = self._prepare_frame(frame)
        if self.defer_decode:
            # queue for a batched device decode; carry the 62-soft-bit
            # trellis history manually so checkpoints and a later switch
            # back to sequential mode stay bit-consistent.  The raw
            # (unflipped) frame is kept so the bank can REWIND frames
            # consumed after a deferred lock loss (batch_framing.py).
            pre["raw"] = frame
            pre["prefix"] = self.viterbi._carry.copy()
            self.viterbi._carry = pre["soft"][-62:].astype(np.float32)
            # relock on UW mismatch is evaluated here (with the dcd as of
            # the last drained batch — at most one frame stale) so the
            # feed loop's consume/search decisions don't wait on the
            # deferred decode
            self._maybe_relock(pre["uw_errors"])
            pre["lock_gen"] = self._lock_gen
            self._pending.append(pre)
            return []
        decoded = self.viterbi.decode(pre["soft"])
        info_bits = scramble_bits(decoded)
        return [self._finish_frame(pre, bits_to_bytes_lsb(info_bits), None)]

    def _prepare_frame(self, frame: np.ndarray) -> dict:
        """Host-side frame prep: arm flip, header, UW errors, deinterleave.
        Returns everything the (possibly deferred) decode needs."""
        spec = self.spec
        frame = self._apply_arm_flip(frame)
        hdr = frame[: spec.header_bits]
        frameinfo = 0
        for b in (hdr >= 128).astype(int):
            frameinfo = (frameinfo << 1) | int(b)
        p0 = spec.header_bits + spec.dummy_bits
        payload = frame[p0: p0 + spec.payload_soft_bits]
        uw = frame[p0 + spec.payload_soft_bits:]
        uw_hard = (uw >= 128).astype(np.int32)
        r = spec.uw_repeat
        if self.phase_invariant:
            arm_errors = [int(np.sum(uw_hard[arm::r]
                                     != self._uw_pattern[arm::r]))
                          for arm in range(r)]
            uw_errors = sum(min(e, len(uw) // r - e) for e in arm_errors)
            if r > 1:
                self._rederive_arm_flip(arm_errors)
        else:
            uw_errors = int(np.sum(uw_hard != self._uw_pattern))

        blocklen = 64 * spec.cols
        didx = deinterleave_indices(spec.cols)
        soft = np.concatenate(
            [payload[b * blocklen:(b + 1) * blocklen][didx]
             for b in range(spec.blocks_per_frame)])
        return {"soft": soft, "frameinfo": frameinfo, "uw_errors": uw_errors}

    def _rederive_arm_flip(self, arm_errors: list) -> bool:
        """Each arm's polarity for the next frame, from the UW in front of
        it: this frame's trailing UW, whose bit errors per arm
        (``arm_errors``) were counted with the polarity this frame was read
        with.  An arm more than half of whose UW bits read wrong has
        flipped since (the test ``_calibrate_arm_flip`` makes at lock).
        Returns whether an arm flipped."""
        n = len(self._uw_pattern) // self.spec.uw_repeat
        toggle = np.array([e > n // 2 for e in arm_errors])
        if not toggle.any():
            return False
        self._arm_flip = self._arm_flip ^ toggle
        return True

    def _maybe_relock(self, uw_errors: int):
        """UW mismatch -> back to searching.

        Two regimes: a NOISY aligned UW (a few bit errors) keeps lock
        while the DCD hysteresis rides through the fade, but a MISALIGNED
        UW — a timing slip under sample-clock offset renormalizes the
        demod grid by one strobe — reads ~n/4 errors after polarity
        folding, far beyond anything noise produces on an aligned UW.
        Waiting for the DCD to bleed out there costs 2-3 frames per slip
        (measured under ±100 ppm clock offset); dropping lock immediately
        re-finds the shifted UW within the buffered stream instead."""
        max_uw_err = self.uw_tolerance + (0 if not self.phase_invariant else 2)
        # threshold n/3: a misaligned (slipped) UW folds to ~0.43n errors,
        # so slips still trip it, while a deep-but-aligned fade would need
        # hard-bit BER ~0.25 to reach n/3 by noise — beyond Viterbi's
        # working range anyway, so decodable fades keep riding the DCD
        # hysteresis instead of being dropped (slips are normally already
        # absorbed upstream by apply_slip; this is the fallback)
        hard_lost = uw_errors >= max(8, len(self._uw_pattern) // 3)
        if hard_lost or (uw_errors > max_uw_err and not self.dcd):
            self.locked = False

    def _finish_frame(self, pre: dict, infofield: bytes,
                      su_ok_in) -> FrameEvent:
        """SU CRC bookkeeping + DCD hysteresis + event build.  ``su_ok_in``
        is the device batch's per-SU verdict, or None to compute here."""
        su_ok = []
        for k in range(len(infofield) // 12):
            if su_ok_in is not None:
                ok = bool(su_ok_in[k])
            else:
                su = infofield[k * 12:(k + 1) * 12]
                crc_calc = crc16_bytes(su[:10])
                crc_rec = su[11] << 8 | su[10]
                ok = crc_calc == crc_rec
                if not ok and crc_rec == 0 and all(b == 0 for b in su[:10]):
                    ok = True  # all-zero SUs pass (ref: aerol.cpp:1537-1543)
            su_ok.append(ok)
            self.dcd_count = (min(self.dcd_count + 2, 12) if ok
                              else max(self.dcd_count - 3, 0))
        if not self.dcd and self.dcd_count > 2:
            self.dcd = True
        if self.dcd and self.dcd_count == 0:
            self.dcd = False
        # in deferred mode this re-runs the prepare-time relock check with
        # the now-updated DCD, so lock loss lands before the next drain's
        # feed — same outcome as sequential whenever at most one frame per
        # VFO arrives per drain (the steady-state case).  Guarded by the
        # lock generation: if a prepare-time relock already fired and a NEW
        # sync was acquired in the same feed, this stale frame's UW errors
        # must not unlock it.
        if pre.get("lock_gen", self._lock_gen) == self._lock_gen:
            self._maybe_relock(pre["uw_errors"])

        ev = FrameEvent(self.frame_index, infofield, su_ok,
                        pre["frameinfo"], pre["uw_errors"])
        self.frame_index += 1
        return ev
