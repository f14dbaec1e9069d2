"""MSB-first bit readers/writers for the binary ATS application payloads.

ADS-C (DO-258A tagged binary groups) and CPDLC (ASN.1 UPER) are both
MSB-first bit streams carried as hex text inside ARINC 622 envelopes.
The reference delegates them to libacars (`la_acars_decode_apps`,
ref: decode/decode.cpp:50-58); aero-tpu decodes them natively, and this
module is the shared bit plumbing.  Pure host-side Python by design —
these run per decoded frame (microseconds), never on device.
"""

from __future__ import annotations


class BitReader:
    """MSB-first reader over a bytes object."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                      # bit position

    @property
    def bits_left(self) -> int:
        return 8 * len(self.data) - self.pos

    def read(self, n: int) -> int:
        """Read ``n`` bits as an unsigned int.  Raises EOFError if short."""
        if n < 0 or self.bits_left < n:
            raise EOFError(f"need {n} bits, have {self.bits_left}")
        v = 0
        pos = self.pos
        for _ in range(n):
            byte = self.data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        """Read ``n`` bits as two's-complement signed."""
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_bytes(self, n: int) -> bytes:
        """Read ``n`` whole bytes (need not be byte-aligned)."""
        return bytes(self.read(8) for _ in range(n))

    def skip(self, n: int) -> None:
        self.read(n)

    def remainder_hex(self) -> str:
        """Hex dump of all remaining bits (final partial byte left-padded
        into a whole byte), for 'undecoded tail' reporting."""
        out = bytearray()
        while self.bits_left >= 8:
            out.append(self.read(8))
        if self.bits_left:
            n = self.bits_left
            out.append(self.read(n) << (8 - n))
        return out.hex().upper()


class BitWriter:
    """MSB-first writer (used by the synthetic encoders in tests)."""

    def __init__(self):
        self._bits: list[int] = []

    def write(self, value: int, n: int) -> "BitWriter":
        if n and not (0 <= value < (1 << n)):
            value &= (1 << n) - 1
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def write_signed(self, value: int, n: int) -> "BitWriter":
        return self.write(value & ((1 << n) - 1), n)

    def write_bytes(self, data: bytes) -> "BitWriter":
        for b in data:
            self.write(b, 8)
        return self

    @property
    def bit_len(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        out = bytearray()
        bits = self._bits
        for i in range(0, len(bits), 8):
            chunk = bits[i:i + 8]
            v = 0
            for b in chunk:
                v = (v << 1) | b
            v <<= 8 - len(chunk)
            out.append(v)
        return bytes(out)
