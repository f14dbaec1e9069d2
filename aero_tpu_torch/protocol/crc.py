"""Aero-L CRC-16 ("GENIBUS-like"): reflected poly 0x8408, init 0xFFFF, final NOT.

Behavioral equivalent of AeroLcrc16 (ref: decode/aerol.h:269-404).  Bits are
processed LSB-first; the byte variant feeds each byte LSB-first, matching the
LSB-first bit packing used throughout the Aero-L stack.

Implemented as a vectorized table-driven CRC over numpy arrays — these run on
the host per decoded frame (dozens of bytes), not on device.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x8408


def _make_table() -> np.ndarray:
    tbl = np.empty(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ _POLY
            else:
                crc >>= 1
        tbl[byte] = crc
    return tbl


_TABLE = _make_table()


def crc16_bytes(data) -> int:
    """CRC over bytes (each consumed LSB-first). ref: aerol.h:332-367."""
    data = np.asarray(bytearray(data) if isinstance(data, (bytes, bytearray)) else data,
                      dtype=np.uint8)
    crc = np.uint16(0xFFFF)
    for b in data:
        crc = np.uint16((crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF])
    return int(crc) ^ 0xFFFF


def crc16_bits(bits) -> int:
    """CRC over a bit array (LSB-first stream). ref: aerol.h:308-331."""
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        # bit-exact fallback for non-byte-multiple lengths
        crc = 0xFFFF
        for b in bits:
            lsb = crc & 1
            crc >>= 1
            if lsb ^ int(b):
                crc ^= _POLY
        return crc ^ 0xFFFF
    by = np.packbits(bits.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)
    return crc16_bytes(by)


def crc16_check_bits(bits) -> bool:
    """Verify a bit block whose last 16 bits hold the CRC.

    The received CRC is read MSB-first from the tail: bit[n-1] is crc bit 15
    ... bit[n-16] is crc bit 0 (ref: aerol.h:273-307).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n = len(bits)
    crc_rec = 0
    for i in range(n - 1, n - 17, -1):
        crc_rec = (crc_rec << 1) | int(bits[i])
    return crc16_bits(bits[: n - 16]) == crc_rec


def append_crc16_bits(bits) -> np.ndarray:
    """Message bits + 16 CRC bits laid out so crc16_check_bits passes."""
    bits = np.asarray(bits, dtype=np.uint8)
    crc = crc16_bits(bits)
    tail = np.array([(crc >> k) & 1 for k in range(16)], dtype=np.uint8)
    return np.concatenate([bits, tail])


def append_crc16_bytes(data: bytes) -> bytes:
    """Message bytes + CRC-16 little-endian (matches SU layout:
    aerol.cpp:1532-1535 reads rec = byte[11]<<8 | byte[10])."""
    crc = crc16_bytes(data)
    return bytes(data) + bytes([crc & 0xFF, (crc >> 8) & 0xFF])
