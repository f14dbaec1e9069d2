"""Aero-L additive scrambler: 15-stage LFSR, taps s0 xor s14.

Behavioral equivalent of AeroLScrambler (ref: decode/aerol.h:406-440):
initial state 110100101011001 (s0 first), output bit = s0^s14, state shifts
toward s14 with the new bit entering at s0.  The keystream is precomputed to
5000 bits exactly as the reference does, and applied with a running position
that the framer resets at each frame boundary.
"""

from __future__ import annotations

import numpy as np


def _make_keystream(n: int = 5000) -> np.ndarray:
    state = np.array([1, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 0, 1], dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    for a in range(n):
        v = state[0] ^ state[14]
        out[a] = v
        state[1:] = state[:-1]
        state[0] = v
    return out


SCRAMBLE_KEYSTREAM = _make_keystream()


def scramble_bits(bits, position: int = 0) -> np.ndarray:
    """XOR bits with the keystream starting at ``position`` (self-inverse)."""
    bits = np.asarray(bits, dtype=np.uint8)
    ks = SCRAMBLE_KEYSTREAM[position: position + len(bits)]
    if len(ks) < len(bits):
        raise ValueError("keystream exhausted (frame longer than 5000 bits)")
    return bits ^ ks
