"""Batched C-channel frame decoding (torch).

The C (8400 bps voice) channels' counterpart of ``batch_framing.py``'s P
bank.  ``CChannelFramer`` (``c_framing.py``, a verbatim copy of the JAX
package's) decodes each frame as it cuts it: one host Viterbi of 2785
steps a frame.  Here the cut and the decode come apart.

``DeferredCChannelFramer`` keeps the framer's loop (UW search, lock, cut,
arm flip, UW score, lock loss: each read from the raw frame, none from
the decode) and queues each frame it cuts as one row of soft bytes: the
62-soft-bit trellis history, the payload deinterleaved and depunctured by
one static gather, and 48 neutral lookahead bits -- the buffer
``StreamingViterbi.decode`` builds -- with the frame's index and UW errors
as they stand at the cut.  The history (``viterbi._carry``) moves on at
the cut, as the decode moves it, so a checkpoint reads the same state.

``BatchCChannelFramerBank.feed`` takes a drain's rows, one per topic, as
the P bank's ``feed`` does: every framer cuts its frames, then one flush
decodes every queued row in one call:

    Viterbi          ``ops/viterbi_kernel.py:viterbi_decode_rows``: the
                     CUDA kernel on a card (uint8 rows, padded to a power
                     of two with 128s, one graphed step per padded N:
                     ``batch_decode_c_frames``); on the CPU the native
                     host decoder row by row where it was built (the
                     sequential framer's), else the kernel's plain-torch
                     twin, on the rows as they are
    descramble       XOR with the keystream
    gather, pack     the 3 SUs' 288 signalling bits and the 2400 voice
                     bits, packed LSB-first into 36 + 300 bytes
    CRC-16           the SUs' CRCs through ``crc16_check_batch``'s GF(2)
                     map (a C SU has no all-zero rule)

and only the bytes and CRC flags come back to the host, which finishes
the frames framer by framer in the order they were cut: the
``CFrameEvent``, a call-progress SU and its hex, the voice sink, in
``_decode_frame``'s order.  Events, voice calls and trellis history equal
the sequential framers' (tests/test_torch_c_bank.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aero_tpu_torch.ops.viterbi_kernel import (soft_to_bytes,
                                               viterbi_decode_rows)
from aero_tpu_torch.protocol.batch_framing import crc16_check_batch
from aero_tpu_torch.protocol.c_framing import (C_MESSAGE_NAMES, FRAME_BITS,
                                               GROUP, INFO_BITS, UW_PAIR,
                                               CChannelFramer, CFrameEvent)
from aero_tpu_torch.protocol.interleaver import (deinterleave_indices,
                                                 depuncture_soft)
from aero_tpu_torch.protocol.scrambler import SCRAMBLE_KEYSTREAM
from aero_tpu_torch.protocol.viterbi import StreamingViterbi
from aero_tpu_torch.utils.graphs import stateless
from aero_tpu_torch.utils.profiling import TRACER

HISTORY = StreamingViterbi.HISTORY              # 62
LOOKAHEAD = StreamingViterbi.LOOKAHEAD          # 48
CODED = 5460                    # a frame's soft bits after depuncturing
ROW = HISTORY + CODED + LOOKAHEAD               # 5570: T = 2785 steps

# a decoded row's bytes: 3 SUs of 12, 300 of voice, then 3 CRC flags
SU_BYTES = 36
VOICE_BYTES = 300
OUT_BYTES = SU_BYTES + VOICE_BYTES + 3

_UW = UW_PAIR.astype(bool)


@functools.lru_cache(maxsize=None)
def _gather() -> np.ndarray:
    """[CODED] index into [payload (4096), 128]: the 16 64x4 block
    deinterleaves and ``depuncture_soft`` as one gather (index 4096 is
    the neutral bit a depuncture inserts)."""
    perm = (np.arange(FRAME_BITS // 256)[:, None] * 256
            + deinterleave_indices(4)[None, :]).reshape(-1)
    # depuncture the indices themselves, moved clear of the 128 it inserts
    marked = depuncture_soft(perm + 256, 4)
    idx = np.where(marked >= 256, marked - 256, FRAME_BITS)
    assert idx.shape == (CODED,)
    return idx


def _picks() -> np.ndarray:
    """Positions in a frame's 2714 info bits of the 3 SUs' 288 signalling
    bits (12 after each of the first 24 groups' voice), then of the 2400
    voice bits (96 in each of 25 groups)."""
    sig = [np.arange(y * GROUP + 97, y * GROUP + 109) for y in range(24)]
    voice = [np.arange(y * GROUP + 1, y * GROUP + 97) for y in range(25)]
    return np.concatenate(sig + voice)


@functools.lru_cache(maxsize=None)
def _tables_on(device):
    """The keystream, the picks and the bit weights of a byte on
    ``device``, built once (before a capture: a host copy inside one would
    fail it)."""
    ks = SCRAMBLE_KEYSTREAM[:INFO_BITS].astype(np.uint8)
    return (torch.from_numpy(ks).to(device),
            torch.from_numpy(_picks()).to(device),
            torch.tensor([1 << k for k in range(8)], dtype=torch.int32,
                         device=device))


def c_frame_outputs(bits):
    """Decoded rows [N, ROW // 2] (0/1 uint8) -> [N, OUT_BYTES] uint8:
    the 3 SUs' bytes, the 300 voice bytes and the SUs' CRC flags (0/1)."""
    ks, picks, weights = _tables_on(bits.device)
    h = HISTORY // 2
    info = torch.bitwise_xor(bits[:, h: h + INFO_BITS], ks)
    n = info.shape[0]
    picked = info[:, picks]
    packed = torch.sum(picked.reshape(n, -1, 8).to(torch.int32) * weights,
                       dim=-1, dtype=torch.int32).to(torch.uint8)
    ok = crc16_check_batch(picked[:, : 8 * SU_BYTES].reshape(n * 3, 96))
    return torch.cat([packed, ok.reshape(n, 3).to(torch.uint8)], dim=1)


def batch_decode_c_frames(soft):
    """Rows of soft bytes [N, ROW] (history, depunctured payload,
    lookahead) -> [N, OUT_BYTES] uint8 (``c_frame_outputs``).  A CUDA
    tensor must be uint8 and decodes with the kernel; a CPU tensor on the
    host (``viterbi_decode_rows``)."""
    return c_frame_outputs(viterbi_decode_rows(soft))


class DeferredCChannelFramer(CChannelFramer):
    """``CChannelFramer`` whose frames decode in a bank's flush: its
    ``feed`` runs the parent's loop, queues each frame it cuts in
    ``_pending`` and returns one None per frame queued."""

    def __init__(self, on_voice=None, on_call_progress=None,
                 uw_tolerance: int = 6):
        super().__init__(on_voice, on_call_progress, uw_tolerance)
        self._pending = []      # (frame index, row, UW errors) per cut
        # a payload and the neutral bit a depuncture inserts: the gather's
        # source
        self._src = np.full(FRAME_BITS + 1, 128.0, np.float32)

    def _decode_frame(self, frame: np.ndarray) -> None:
        """The cut: the parent's arm flip, UW score and lock loss, then
        the frame's row queued and the trellis history moved on."""
        if self._flip.any():
            frame = frame.copy()
            for arm in (0, 1):
                if self._flip[arm] > 0:
                    frame[arm::2] = 255.0 - frame[arm::2]
        miss = (frame[FRAME_BITS:] >= 128) != _UW
        e0 = int(np.count_nonzero(miss[0::2]))
        e1 = int(np.count_nonzero(miss[1::2]))
        uw_errors = min(e0, 52 - e0) + min(e1, 52 - e1)
        if uw_errors > self.uw_tolerance + 4:
            self.locked = False

        row = np.empty(ROW, np.float32)
        row[:HISTORY] = self.viterbi._carry
        self._src[:FRAME_BITS] = frame[:FRAME_BITS]
        np.take(self._src, _gather(), out=row[HISTORY: HISTORY + CODED])
        row[HISTORY + CODED:] = 128.0
        self.viterbi._carry = row[CODED: HISTORY + CODED].copy()
        self._pending.append((self.frame_index, row, uw_errors))
        self.frame_index += 1

    def _finish(self, item, out: np.ndarray) -> CFrameEvent:
        """A queued frame's event from its decoded bytes ``out``
        [OUT_BYTES]: ``_decode_frame``'s bookkeeping after its decode."""
        frame_index, _, uw_errors = item
        signalling = []
        for k in range(3):
            su = out[12 * k: 12 * (k + 1)].tobytes()
            crc_ok = bool(out[SU_BYTES + VOICE_BYTES + k])
            name = C_MESSAGE_NAMES.get(su[0], "Other") if crc_ok else ""
            if crc_ok and su[0] == 0x30:
                self.on_call_progress(su)
                self._hex = su[1:4].hex().upper()
            signalling.append((su, crc_ok, name))
        voice = out[SU_BYTES: SU_BYTES + VOICE_BYTES].tobytes()
        self.on_voice(voice, self._hex)
        return CFrameEvent(frame_index, signalling, voice, uw_errors)


class BatchCChannelFramerBank:
    """C-channel framers, one per topic, with ONE batched decode per
    drain: ``feed(rows)``, the P bank's interface.  ``on_voice`` maps a
    topic to its voice sink.

    While the tracer is on, a feed is a ``framers.c`` span (the framers'
    UW search and frame cuts, the flush, the voice sinks), its frames
    counted in ``c.frames``, and inside it a flush is a
    ``framers.c.decode`` span (stack, pad, the decode, its outputs on the
    host), counted in ``c.decode.calls``, ``c.decode.rows`` (frames) and
    ``c.decode.rows_launched`` (rows with the padding)."""

    def __init__(self, topics, on_voice=None, device="cpu"):
        on_voice = on_voice or {}
        self.device = torch.device(device)
        self._decode = stateless(batch_decode_c_frames,
                                 "batch_decode_c_frames", self.device)
        self.framers = {t: DeferredCChannelFramer(on_voice=on_voice.get(t))
                        for t in topics}

    def feed(self, rows: dict) -> dict:
        """rows: {topic: soft float array}, slips realigned.  Every
        framer cuts its frames, then one flush decodes them all.  Returns
        {topic: [CFrameEvent]}, each topic's in cut order."""
        with TRACER.span("framers.c"):
            for t, row in rows.items():
                self.framers[t].feed(row)
            out = self.flush()
        n = sum(len(evs) for evs in out.values())
        if n:
            TRACER.count("c.frames", n)
        return out

    def flush(self) -> dict:
        """Decode every queued frame and finish them, framer by framer in
        cut order: {topic: [CFrameEvent]}."""
        out = {t: [] for t in self.framers}
        pend = [(t, item) for t, f in self.framers.items()
                for item in f._pending]
        if not pend:
            return out
        for f in self.framers.values():
            f._pending = []
        if TRACER.on:
            TRACER.open("framers.c.decode")
        dec, launched = self._run(np.stack([row for _, (_, row, _) in pend]))
        if TRACER.on:
            TRACER.close()
            TRACER.count("c.decode.calls")
            TRACER.count("c.decode.rows", len(pend))
            TRACER.count("c.decode.rows_launched", launched)
        for i, (t, item) in enumerate(pend):
            out[t].append(self.framers[t]._finish(item, dec[i]))
        return out

    def _run(self, rows: np.ndarray):
        """Rows [n, ROW] (float32 soft values) -> (their outputs [n,
        OUT_BYTES] uint8 numpy, rows decoded with the padding)."""
        n = len(rows)
        if self.device.type == "cpu":
            # eager on the host: float32 rows, no graph to key, no padding
            return self._decode(torch.from_numpy(rows)).numpy(), n
        # uint8 bytes for the kernel on a card (whole numbers in 0..255,
        # checked on the host), padded to a power of two: one graph per
        # padded N
        soft = soft_to_bytes(rows)
        n_pad = 1 << (n - 1).bit_length()
        if n_pad > n:
            soft = np.concatenate(
                [soft, np.full((n_pad - n, ROW), 128, soft.dtype)])
        return self._decode(torch.from_numpy(soft)).cpu().numpy()[:n], n_pad
