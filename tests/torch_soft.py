"""Soft-byte inputs for the Viterbi decoders, shared by the port's tests and
chip_smoke.py (imports no JAX: the card's machine has none)."""

import numpy as np

from aero_tpu_torch.protocol.viterbi import conv_encode


def soft_bytes(kind, B, T, seed=0):
    """[B, 2T] soft bytes (0..255) from a numpy seed.

    float32: ``integral``: conv_encode of random bits plus noise, rounded
    to whole bytes; ``float``: uniform random floats (the twin and JAX
    take them; the kernel does not); ``all128``: every compare of the
    trellis ties.  uint8: ``random``: uniform whole bytes; ``extreme``:
    random 0/255 only, the fastest growth of the path metrics."""
    rng = np.random.default_rng(seed)
    if kind == "integral":
        bits = rng.integers(0, 2, size=(B, T)).astype(np.uint8)
        coded = np.stack([conv_encode(b) for b in bits]).astype(np.float32)
        return np.clip(np.round((coded * 2 - 1
                                 + rng.normal(0, 0.6, coded.shape))
                                * 127 + 128), 0, 255).astype(np.float32)
    if kind == "float":
        return rng.uniform(0, 255, size=(B, 2 * T)).astype(np.float32)
    if kind == "random":
        return rng.integers(0, 256, size=(B, 2 * T), dtype=np.uint8)
    if kind == "extreme":
        return (255 * rng.integers(0, 2, size=(B, 2 * T))).astype(np.uint8)
    if kind == "all128":
        return np.full((B, 2 * T), 128.0, np.float32)
    raise ValueError(kind)


# the kinds the CUDA kernel takes (whole bytes), for its tests on the card
KERNEL_KINDS = ("integral", "random", "extreme", "all128")
