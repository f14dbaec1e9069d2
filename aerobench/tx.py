"""The transmit side of Inmarsat Aero, frozen for the benchmark's traffic.

A copy of what the generator needs from the port's TX helpers (P-frame
build, ISU/ACARS user data, CRC-16, scrambler, K=7 r=1/2 convolutional
encoder, 64-row interleaver, R/T bursts, C frames), in numpy, importing
nothing of the port.  Two departures, both for a capture that is replayed
in a loop without a seam:

- the P and C streams are built for a whole pass of frames and encoded
  tail-biting (the encoder's register starts from the last 6 bits of the
  pass), so the coded stream of pass n+1 follows pass n as it would follow
  itself;
- frame j's payload carries infofield j (``build_p_frames`` shifts by one
  and pads with lead frames, which a periodic stream does not need).

Bits of bytes are LSB first throughout, as on the air.
"""

from __future__ import annotations

import functools

import numpy as np

POLYS = (109, 79)

# P-channel frame layout per data rate: interleaver columns, blocks per
# frame, header bits, dummy bits, UW repeat (ref decode/aerol.cpp:960-1039)
P_SPECS = {
    600: (6, 3, 16, 0, 1),
    1200: (9, 2, 16, 0, 1),
    10500: (78, 1, 16, 178, 2),
}

UW = 3780831379          # 0xE15AE893, MSB first
UW_BITS = np.array([(UW >> i) & 1 for i in range(31, -1, -1)], np.uint8)

# C channel (8400 bps): 4096 coded soft bits + the dual 52-bit UW per frame
C_FRAME_BITS = 4096
C_INFO_BITS = 2714
C_CODED_INFO = 2730
C_GROUP = 109
C_UW_I = 0xAB376938BCA30
C_UW_Q = 0xC53D1C96ECD5

FILL_SU = None           # set below: 0x01 fill SU with its CRC


def p_frame_bits(rate: int) -> int:
    cols, blocks, hdr, dummy, rep = P_SPECS[rate]
    return hdr + dummy + 64 * cols * blocks + 32 * rep


def p_sus_per_frame(rate: int) -> int:
    cols, blocks, *_ = P_SPECS[rate]
    return 64 * cols * blocks // 2 // 96


def c_frame_bits() -> int:
    return C_FRAME_BITS + 104


# ---- CRC-16 (reflected 0x8408, init 0xFFFF, final NOT) ---------------------

def _crc_table() -> np.ndarray:
    tbl = np.empty(256, np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        tbl[byte] = crc
    return tbl


_CRC_TABLE = _crc_table()


def crc16(data: bytes) -> int:
    crc = 0xFFFF
    for b in data:
        crc = (crc >> 8) ^ int(_CRC_TABLE[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFF


def with_crc(data: bytes) -> bytes:
    """Bytes + CRC-16 little-endian (an SU's bytes 10 and 11)."""
    c = crc16(data)
    return bytes(data) + bytes([c & 0xFF, c >> 8])


FILL_SU = with_crc(bytes([0x01] + [0] * 9))


# ---- bits -------------------------------------------------------------------

def bits_lsb(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8),
                         bitorder="little")


@functools.lru_cache(maxsize=None)
def _keystream(n: int = 5000) -> np.ndarray:
    """The 15-stage LFSR keystream (s0 ^ s14), restarted every frame."""
    state = [1, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 0, 1]
    out = np.empty(n, np.uint8)
    for a in range(n):
        v = state[0] ^ state[14]
        out[a] = v
        state = [v] + state[:-1]
    return out


def scramble(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, np.uint8) ^ _keystream()[:len(bits)]


def conv_encode(bits: np.ndarray, tail_biting: bool = False) -> np.ndarray:
    """K=7 r=1/2 encoder, newest bit at the register's LSB, output i =
    parity(reg & POLYS[i]); the register starts at 0, or tail-biting from
    the stream's last 6 bits."""
    bits = np.asarray(bits, np.uint8)
    head = bits[-6:] if tail_biting else np.zeros(6, np.uint8)
    ext = np.concatenate([head, bits]).astype(np.uint8)
    n = len(bits)
    out = np.empty(2 * n, np.uint8)
    for o, poly in enumerate(POLYS):
        acc = np.zeros(n, np.uint8)
        for m in range(7):
            if (poly >> m) & 1:
                acc ^= ext[6 - m: 6 - m + n]
        out[o::2] = acc
    return out


@functools.lru_cache(maxsize=None)
def deinterleave_indices(cols: int) -> np.ndarray:
    """out[k] = in[idx[k]]: column j, rows (i*27) % 64, of a row-major
    [64, cols] block."""
    rows = (np.arange(64) * 27) % 64
    return (rows[None, :] * cols + np.arange(cols)[:, None]).reshape(-1)


@functools.lru_cache(maxsize=None)
def interleave_indices(cols: int) -> np.ndarray:
    d = deinterleave_indices(cols)
    inv = np.empty_like(d)
    inv[d] = np.arange(len(d))
    return inv


@functools.lru_cache(maxsize=None)
def deinterleave_msk_burst_indices(blocks: int) -> np.ndarray:
    """Burst MSK layout: one 5-column block, then 3-column groups."""
    rows = (np.arange(64) * 27) % 64
    parts = [(rows[None, :] * 5 + np.arange(5)[:, None]).reshape(-1)]
    proc = 5
    while sum(len(p) for p in parts) < blocks * 64:
        parts.append((64 * proc + rows[None, :] * 3
                      + np.arange(3)[:, None]).reshape(-1))
        proc += 3
    return np.concatenate(parts)[:blocks * 64]


def puncture(coded: np.ndarray, pattern: int) -> np.ndarray:
    keep = np.ones(len(coded), bool)
    keep[pattern - 1::pattern] = False
    return coded[keep]


# ---- ACARS user data and ISUs -----------------------------------------------

def _parity7(byte: int) -> int:
    b = byte & 0x7F
    return b | 0x80 if bin(b).count("1") % 2 == 0 else b


def acars_userdata(mode: str, reg: str, tak: str, label: str, bi: str,
                   text: str) -> bytes:
    """ISU user data of one ACARS message, odd parity on each character."""
    out = bytearray([0xFF, 0xFF, _parity7(0x01), _parity7(ord(mode))])
    out += bytes(_parity7(ord(ch)) for ch in reg.rjust(7, "."))
    out += bytes([_parity7(ord(tak)), _parity7(ord(label[0])),
                  _parity7(ord(label[1])), _parity7(ord(bi))])
    if text:
        out.append(_parity7(0x02))
        out += bytes(_parity7(ord(ch)) for ch in text)
        out.append(_parity7(0x83))
    else:
        out.append(_parity7(0x83))
    out += bytes([0x93, 0xAB, _parity7(0x7F)])
    return bytes(out)


def segment_isu(userdata: bytes, aesid: int, gesid: int, qno: int = 0,
                refno: int = 0) -> list:
    """One 0x71 initial SU and 0xC0 SSUs, 10-byte bodies without CRC."""
    n = len(userdata)
    nssu = max(0, -(-(n - 2) // 8))
    nooct = n - 2 - 8 * (nssu - 1) if nssu else 0
    qr = ((qno & 0xF) << 4) | (refno & 0xF)
    sus = [bytes([0x71, (aesid >> 16) & 0xFF, (aesid >> 8) & 0xFF,
                  aesid & 0xFF, gesid, qr, nssu & 0x3F,
                  (nooct & 0xF) << 4]) + userdata[:2]]
    pos = 2
    for k in range(nssu):
        chunk = userdata[pos:pos + 8]
        pos += len(chunk)
        sus.append((bytes([0xC0 | (nssu - 1 - k), qr]) + chunk)
                   .ljust(10, b"\x00"))
    return sus


def acars_sus(aesid: int, gesid: int, reg: str, text: str) -> list:
    """The 12-byte SUs (with CRCs) of one downlink ACARS message."""
    ud = acars_userdata("2", reg, "!", "H1", "A", text)
    return [with_crc(s) for s in segment_isu(ud, aesid, gesid)]


def n_acars_sus(text_len: int) -> int:
    n = 20 + text_len
    return 1 + -(-(n - 2) // 8)


# ---- P channel ---------------------------------------------------------------

def _frameinfo(fc: int) -> np.ndarray:
    val = (1 << 12) | ((fc & 0xF) << 4) | (fc & 0xF)
    return np.array([(val >> i) & 1 for i in range(15, -1, -1)], np.uint8)


def p_stream(infofields: list, rate: int) -> np.ndarray:
    """The periodic P-channel bit stream of one pass: frame j carries
    infofield j (``p_sus_per_frame`` SUs of 12 bytes); the frame counter
    runs mod 16, so a pass of a multiple of 16 frames repeats cleanly."""
    cols, blocks, hdr, dummy, rep = P_SPECS[rate]
    nbits = 64 * cols * blocks // 2
    info = np.concatenate([scramble(bits_lsb(f)) for f in infofields])
    assert len(info) == nbits * len(infofields)
    coded = conv_encode(info, tail_biting=True).reshape(len(infofields), -1)
    inter = interleave_indices(cols)
    uw = np.repeat(UW_BITS, rep)
    out = []
    for j, seg in enumerate(coded):
        body = seg.reshape(blocks, 64 * cols)[:, inter].reshape(-1)
        out += [_frameinfo(j), np.zeros(dummy, np.uint8), body, uw]
    return np.concatenate(out)


# ---- C channel ---------------------------------------------------------------

def _bits_msb(val: int, n: int) -> np.ndarray:
    return np.array([(val >> i) & 1 for i in range(n - 1, -1, -1)], np.uint8)


def _c_uw_pair() -> np.ndarray:
    pair = np.empty(104, np.uint8)
    pair[0::2] = _bits_msb(C_UW_Q, 52)
    pair[1::2] = _bits_msb(C_UW_I, 52)
    return pair


def c_stream(frames: list) -> np.ndarray:
    """The periodic C-channel bit stream of one pass: frames of
    (3 signalling SUs of 12 bytes, 300 voice bytes), encoded continuously
    and tail-biting over the pass, punctured (pattern 4) and interleaved
    per 256 bits, each followed by the dual UW."""
    payloads = []
    for sus, voice in frames:
        bits = np.zeros(C_INFO_BITS, np.uint8)
        vb = bits_lsb(voice)
        sb = np.concatenate([bits_lsb(s) for s in sus])
        for y in range(25):
            bits[y * C_GROUP + 1: y * C_GROUP + 97] = vb[y * 96:(y + 1) * 96]
        for y in range(24):
            bits[y * C_GROUP + 97: y * C_GROUP + 109] = sb[y * 12:(y + 1) * 12]
        payloads.append(np.concatenate(
            [scramble(bits), np.zeros(C_CODED_INFO - C_INFO_BITS, np.uint8)]))
    coded = conv_encode(np.concatenate(payloads), tail_biting=True)
    coded = coded.reshape(len(frames), 2 * C_CODED_INFO)
    inter = interleave_indices(4)
    uw = _c_uw_pair()
    out = []
    for seg in coded:
        punct = np.append(puncture(seg, 4), 0).astype(np.uint8)
        assert len(punct) == C_FRAME_BITS
        out.append(punct.reshape(-1, 256)[:, inter].reshape(-1))
        out.append(uw)
    return np.concatenate(out)


# ---- R/T bursts --------------------------------------------------------------

def _burst_payload(info_bits: np.ndarray, rows: int,
                   oqpsk: bool) -> np.ndarray:
    coded = conv_encode(scramble(info_bits))
    idx = (deinterleave_indices(rows) if oqpsk
           else deinterleave_msk_burst_indices(rows))
    inv = np.empty_like(idx)
    inv[idx] = np.arange(len(idx))
    return coded[inv]


def r_burst(info17: bytes, preamble_bits: int = 96) -> np.ndarray:
    """An R packet: 17 bytes + CRC, padded to 5 rows of 32 info bits."""
    assert len(info17) == 17
    bits = np.concatenate([bits_lsb(with_crc(info17)), np.zeros(8, np.uint8)])
    pre = (np.arange(preamble_bits) % 2).astype(np.uint8)
    return np.concatenate([pre, UW_BITS, _burst_payload(bits, 5, False)])


def t_burst(aesid: int, gesid: int, sus: list, oqpsk: bool = True,
            preamble_bits: int = 128) -> np.ndarray:
    """A T packet: 4-byte header + CRC, then SUs (10 bytes + CRC each)."""
    n = len(sus)
    rows = 3 * n + 2 if oqpsk else (n + 1) * 3 + 2
    header = with_crc(bytes([(aesid >> 16) & 0xFF, (aesid >> 8) & 0xFF,
                             aesid & 0xFF, gesid]))
    info = header + b"".join(with_crc(bytes(s[:10])) for s in sus)
    bits = bits_lsb(info)
    bits = np.concatenate([bits, np.zeros(rows * 32 - len(bits), np.uint8)])
    pre = (np.arange(preamble_bits) % 2).astype(np.uint8)
    return np.concatenate([pre, UW_BITS, _burst_payload(bits, rows, oqpsk)])
