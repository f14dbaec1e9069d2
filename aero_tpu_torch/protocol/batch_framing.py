"""Batched P-channel frame decoding (torch).

Counterpart of ``aero_tpu/protocol/batch_framing.py``.  BATCHES of aligned
frames, from many VFOs and/or many frames per VFO, decode in one call:

    deinterleave     gather with the static 64xN permutation
    Viterbi          the CUDA kernel for a CUDA tensor of soft bytes
                     (uint8; ops/viterbi_kernel.py), its plain-torch twin
                     for a CPU tensor
    descramble       XOR with the broadcast keystream row
    CRC-16           GF(2) affine map as a 0/1 float32 matmul: the CRC of
                     an 80-bit SU body is linear over GF(2), so
                     crc(m) = (m @ M) mod 2 xor crc(0)

Host code only finds UW alignments and slices frames.  Trellis continuity
across frames is kept by passing each frame's 62-soft-bit history prefix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aero_tpu_torch.protocol.crc import crc16_bits
from aero_tpu_torch.protocol.scrambler import SCRAMBLE_KEYSTREAM
from aero_tpu_torch.protocol.interleaver import deinterleave_indices
from aero_tpu_torch.protocol.framing import FRAME_SPECS
from aero_tpu_torch.ops.viterbi_kernel import (soft_to_bytes,
                                               viterbi_decode_soft_cuda)

HISTORY = 62
LOOKAHEAD = 48


@functools.lru_cache(maxsize=None)
def _crc_matrix(nbits: int = 80):
    """M [nbits, 16] and c0 [16] with crc(m) = (m @ M) % 2 ^ c0 (bit k of
    the CRC in column k)."""
    c0 = crc16_bits(np.zeros(nbits, np.uint8))
    M = np.zeros((nbits, 16), np.float32)
    for i in range(nbits):
        e = np.zeros(nbits, np.uint8)
        e[i] = 1
        v = crc16_bits(e) ^ c0
        M[i] = [(v >> k) & 1 for k in range(16)]
    c0v = np.asarray([(c0 >> k) & 1 for k in range(16)], np.float32)
    return M, c0v


@functools.lru_cache(maxsize=None)
def _crc_on(device):
    M, c0 = _crc_matrix(80)
    return torch.from_numpy(M).to(device), torch.from_numpy(c0).to(device)


@functools.lru_cache(maxsize=None)
def _frame_tables_on(rate: int, device):
    """Per-device keystream and deinterleave index of a frame rate."""
    spec = FRAME_SPECS[rate]
    ks = SCRAMBLE_KEYSTREAM[: spec.payload_info_bits].astype(np.uint8)
    didx = deinterleave_indices(spec.cols).astype(np.int64)
    return torch.from_numpy(ks).to(device), torch.from_numpy(didx).to(device)


def crc16_check_batch(su_bits):
    """su_bits: [N, 96] 0/1 tensor — returns bool [N] (body CRC == stored
    CRC).  Sums of at most 80 ones are exact in float32."""
    M, c0 = _crc_on(su_bits.device)
    su_bits = su_bits.to(torch.float32)
    calc = torch.remainder(su_bits[:, :80] @ M, 2.0)
    calc = torch.remainder(calc + c0, 2.0)
    # stored CRC: bits[80+k] = crc bit k (LSB-first byte layout)
    rec = su_bits[:, 80:96]
    return torch.all(calc == rec, dim=1)


def batch_decode_p_frames(soft_payloads, prefixes, *, rate: int,
                          use_pallas: bool = False,
                          pre_deinterleaved: bool = False):
    """Decode N aligned P-channel frame payloads in one call.

    soft_payloads: [N, payload_soft_bits] soft bytes (after arm-flip
    correction); prefixes: [N, 62] soft bytes of the coded stream
    immediately before each payload (128s when unknown).  Both are tensors
    on one device: a CUDA tensor decodes with the CUDA kernel, and must
    then be uint8; a CPU tensor decodes with its plain-torch twin in
    float32 (uint8 payloads keep the buffer in uint8, anything else is
    taken as float32).  With ``pre_deinterleaved`` the payloads are
    already in coded-stream order.  ``use_pallas`` is accepted for
    signature compatibility with the JAX version and ignored: the device
    of the input picks the decoder.

    Returns dict(info_bits [N, info] uint8, su_ok [N, n_su] bool).
    """
    del use_pallas
    spec = FRAME_SPECS[rate]
    dt = torch.uint8 if soft_payloads.dtype == torch.uint8 else torch.float32
    soft_payloads = soft_payloads.to(dt)
    dev = soft_payloads.device
    N = soft_payloads.shape[0]
    blocklen = 64 * spec.cols
    ks, didx = _frame_tables_on(rate, dev)

    if pre_deinterleaved:
        deint = soft_payloads
    else:
        payload = soft_payloads.reshape(N, spec.blocks_per_frame, blocklen)
        deint = payload[:, :, didx].reshape(N, -1)

    buf = torch.cat(
        [prefixes.to(device=dev, dtype=dt), deint,
         torch.full((N, LOOKAHEAD), 128, dtype=dt, device=dev)],
        dim=1).contiguous()
    bits_all = viterbi_decode_soft_cuda(buf)

    h = HISTORY // 2
    info = torch.bitwise_xor(bits_all[:, h: h + spec.payload_info_bits], ks)

    n_su = spec.payload_info_bits // 96
    su = info[:, : n_su * 96].reshape(N * n_su, 96)
    ok = crc16_check_batch(su).reshape(N, n_su)
    # all-zero SUs pass (ref: aerol.cpp:1537-1543)
    zeros = torch.all(su == 0, dim=1).reshape(N, n_su)
    return {"info_bits": info, "su_ok": ok | zeros}


class BatchPChannelFramerBank:
    """Many same-rate P-channel framers with ONE batched decode per drain.

    Per-VFO lock search, arm-flip, UW scoring, DCD hysteresis and event
    bookkeeping stay in ``PChannelFramer``, run in ``defer_decode`` mode.
    ``flush()`` decodes every pending frame across all VFOs in one
    ``batch_decode_p_frames`` call on ``device`` and replays each framer's
    bookkeeping in order — the JAX bank's semantics, with the decode call
    swapped (see the JAX docstring for the equivalence with sequential
    framing).
    """

    def __init__(self, rate: int, topics, use_pallas: bool = False,
                 device="cpu"):
        from aero_tpu_torch.protocol.framing import PChannelFramer
        self.rate = rate
        self.use_pallas = use_pallas
        self.device = torch.device(device)
        self.framers = {}
        for t in topics:
            f = PChannelFramer(rate)
            f.defer_decode = True
            self.framers[t] = f

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Soft values to the bank's device: uint8 bytes for the kernel on
        a card (whole numbers in 0..255, checked here on the host), float32
        for the twin on the CPU."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return torch.from_numpy(soft_to_bytes(a)).to(self.device)

    def feed(self, rows: dict) -> dict:
        """rows: {topic: soft float array}.  Queues frames per topic, then
        batch-decodes everything pending.  Returns {topic: [FrameEvent]}."""
        for t, row in rows.items():
            evs = self.framers[t].feed(np.asarray(row, np.float32))
            assert not evs          # deferred mode never emits from feed
        return self.flush()

    def flush(self) -> dict:
        """Decode everything pending, replay bookkeeping, and iterate to a
        fixpoint: if a frame's bookkeeping LOSES the lock, frames of that
        VFO consumed after it are REWOUND (their raw bits go back to the
        framer's buffer and the UW search re-runs) — exactly what the
        sequential framer would have done mid-buffer, so a signal that
        resumes right after a dropout is re-acquired without losing a
        frame (caught by a 50-seed fuzz, 2026-08-21)."""
        from aero_tpu_torch.protocol.framing import bits_to_bytes_lsb
        out = {t: [] for t in self.framers}
        while True:
            pend = [(t, pre) for t, f in self.framers.items()
                    for pre in f._pending]
            if not pend:
                return out
            soft = np.stack([pre["soft"] for _, pre in pend])
            prefixes = np.stack([pre["prefix"] for _, pre in pend])
            # pad the batch to the next power of two, as the JAX bank
            # does, so both decode the same [B, 2T] shapes
            n = len(pend)
            n_pad = 1 << (n - 1).bit_length()
            if n_pad > n:
                soft = np.concatenate(
                    [soft, np.full((n_pad - n,) + soft.shape[1:], 128.0,
                                   soft.dtype)])
                prefixes = np.concatenate(
                    [prefixes,
                     np.full((n_pad - n,) + prefixes.shape[1:], 128.0,
                             prefixes.dtype)])
            dec = batch_decode_p_frames(
                self._tensor(soft), self._tensor(prefixes), rate=self.rate,
                use_pallas=self.use_pallas, pre_deinterleaved=True)
            info_bits = dec["info_bits"].cpu().numpy()
            su_ok = dec["su_ok"].cpu().numpy()

            idx = 0
            rewound = False
            by_topic = {t: [] for t in self.framers}
            for t, pre in pend:
                by_topic[t].append((idx, pre))
                idx += 1
            for t, items in by_topic.items():
                f = self.framers[t]
                f._pending.clear()
                for k, (i, pre) in enumerate(items):
                    out[t].append(f._finish_frame(
                        pre, bits_to_bytes_lsb(info_bits[i]), su_ok[i]))
                    if not f.locked:
                        # lock lost at finish time: un-consume the later
                        # frames AND re-expose the lock-losing frame's
                        # trailing UW region (the sequential feed() does
                        # this on its lock-loss path, framing.py — a
                        # timing slip shifts the boundary a few bits and
                        # relock must land on the SHIFTED UW, not a
                        # whole frame later), then re-run the UW search
                        kk = len(f._uw_pattern) + 16
                        later = [p["raw"] for _, p in items[k + 1:]]
                        f.buf = np.concatenate(
                            [pre["raw"][-kk:]] + later + [f.buf])
                        evs = f.feed(np.zeros(0, np.float32))
                        assert not evs
                        if later:
                            rewound = True
                            break
            if not rewound:
                return out
