"""Plain soft Viterbi for the Aero K=7 r=1/2 code (numpy), and the plain
decode of a batch of P-channel frames: the reference the benchmark holds
the port's batched decode (its CUDA kernel inside) to.

Soft bytes: 0 strong zero, 255 strong one, 128 erasure.  The decoder
starts from an unknown state and ends at the least metric, lowest index
on ties; each step keeps predecessor 1 only when its candidate is
strictly smaller, then subtracts the row minimum.
"""

from __future__ import annotations

import functools

import numpy as np

POLYS = (109, 79)
NSTATES = 64
HISTORY = 62          # soft bits of the coded stream before a payload
LOOKAHEAD = 48        # neutral soft bits after it
# P-frame payload soft bits and interleaver columns per data rate
PAYLOAD = {600: 1152, 1200: 1152, 10500: 4992}


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def tables():
    """PRED[ns, j]: the two predecessors of next state ns; PATTERN[ns, j]:
    the dibit (o0*2 + o1) on that transition."""
    pred = np.empty((NSTATES, 2), np.int64)
    pattern = np.empty((NSTATES, 2), np.int64)
    for ns in range(NSTATES):
        b = ns & 1
        for j, ps in enumerate((ns >> 1, (ns >> 1) | 0x20)):
            reg = ((ps << 1) | b) & 0x7F
            pred[ns, j] = ps
            pattern[ns, j] = (_parity(reg & POLYS[0]) * 2
                              + _parity(reg & POLYS[1]))
    return pred, pattern


def decode(soft: np.ndarray) -> np.ndarray:
    """soft [B, 2T] -> bits [B, T] uint8."""
    s = np.asarray(soft, np.float32)
    B, T = s.shape[0], s.shape[1] // 2
    pred, pattern = tables()
    s0, s1 = s[:, 0::2], s[:, 1::2]
    bm = np.stack([s0 + s1, s0 + (255.0 - s1), (255.0 - s0) + s1,
                   (255.0 - s0) + (255.0 - s1)], axis=-1)     # [B, T, 4]
    pm = np.zeros((B, NSTATES), np.float32)
    surv = np.empty((T, B, NSTATES), bool)
    for t in range(T):
        c0 = pm[:, pred[:, 0]] + bm[:, t][:, pattern[:, 0]]
        c1 = pm[:, pred[:, 1]] + bm[:, t][:, pattern[:, 1]]
        take1 = c1 < c0
        new = np.where(take1, c1, c0)
        pm = new - new.min(axis=1, keepdims=True)
        surv[t] = take1
    state = np.argmin(pm, axis=1)
    bits = np.empty((B, T), np.uint8)
    rows = np.arange(B)
    for t in range(T - 1, -1, -1):
        bits[:, t] = state & 1
        state = pred[state, surv[t][rows, state].astype(np.int64)]
    return bits


@functools.lru_cache(maxsize=None)
def keystream(n: int) -> np.ndarray:
    state = [1, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 0, 1]
    out = np.empty(n, np.uint8)
    for a in range(n):
        v = state[0] ^ state[14]
        out[a] = v
        state = [v] + state[:-1]
    return out


def crc_ok(su_bits: np.ndarray) -> np.ndarray:
    """[N, 96] LSB-first SU bits -> [N] bool: CRC-16 (reflected 0x8408,
    init 0xFFFF, final NOT) of bytes 0..9 equals bytes 10..11, or the SU
    is all zeros."""
    by = np.packbits(su_bits.reshape(len(su_bits), -1, 8)[:, :, ::-1],
                     axis=2).reshape(len(su_bits), 12)
    out = np.empty(len(by), bool)
    for i, row in enumerate(by):
        crc = 0xFFFF
        for b in row[:10]:
            crc ^= int(b)
            for _ in range(8):
                crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        crc ^= 0xFFFF
        out[i] = crc == (int(row[10]) | int(row[11]) << 8) or not row.any()
    return out


def decode_p_frames(soft: np.ndarray, prefixes: np.ndarray, rate: int):
    """Deinterleaved payloads [N, PAYLOAD] and the coded stream's 62 soft
    bits before each [N, 62] -> (info bits [N, PAYLOAD/2], SU CRCs ok
    [N, n_su])."""
    n = len(soft)
    buf = np.concatenate([np.asarray(prefixes, np.float32),
                          np.asarray(soft, np.float32),
                          np.full((n, LOOKAHEAD), 128.0, np.float32)], axis=1)
    bits = decode(buf)
    k = PAYLOAD[rate] // 2
    info = bits[:, HISTORY // 2: HISTORY // 2 + k] ^ keystream(k)
    n_su = k // 96
    ok = crc_ok(info[:, :n_su * 96].reshape(n * n_su, 96)).reshape(n, n_su)
    return info, ok
