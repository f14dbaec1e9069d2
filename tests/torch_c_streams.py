"""C-channel soft streams and a drain's feeding order, shared by
tests/test_torch_c_bank.py and the card's tests/test_torch_cuda.py
(imports no JAX: the card's machine has none).

A case is several VFOs' soft-byte streams (``build_c_frames`` under
noise, each after its own stretch of noise, so that the VFOs lock at
different places) and a feeding plan: the block of soft bits each drain
hands every framer, and the slips it gives.  ``feed_round`` feeds one
drain's blocks to a dict of framers in topic order, as the fused
station's drain does."""

import numpy as np

from aero_tpu_torch.protocol.c_framing import FRAME_BITS, build_c_frames
from aero_tpu_torch.protocol.crc import append_crc16_bytes

FRAME = FRAME_BITS + 104        # soft bits a frame and its UW


def c_frames(rng, n: int, hexes=(b"\xab\xcd\xef",)):
    """n frames: the first SU a call-progress SU (0x30) carrying
    ``hexes[k * len(hexes) // n]`` in frame k, then a fill SU and a random
    one, all with their CRCs, and 300 random voice bytes."""
    out = []
    for k in range(n):
        hx = hexes[k * len(hexes) // n]
        sus = [append_crc16_bytes(bytes([0x30]) + hx
                                  + bytes(rng.integers(0, 256, 6).tolist())),
               append_crc16_bytes(bytes([0x01] + [0] * 9)),
               append_crc16_bytes(bytes(rng.integers(0, 256, 10).tolist()))]
        out.append((sus, bytes(rng.integers(0, 256, 300).tolist())))
    return out


def c_stream(seed: int, n_frames: int = 6, *, sigma: float = 0.45,
             lead: int | None = None, invert_arm: int | None = None,
             hexes=(b"\xab\xcd\xef",), dropout: tuple | None = None):
    """One C channel's soft bytes (float32 whole numbers in 0..255):
    ``lead`` soft bits of noise, then ``n_frames`` frames (``c_frames``)
    after 2 lead frames, BPSK-like soft values under Gaussian noise of
    ``sigma`` (in units of the bit's amplitude).  ``invert_arm`` (0 or 1)
    inverts that OQPSK arm (every other soft bit) from the start;
    ``dropout`` = (start, length) replaces that stretch of the frames
    (``start`` counted from the end of the lead) with noise, so that the
    framer loses its lock and finds it again."""
    rng = np.random.default_rng(seed)
    bits = build_c_frames(c_frames(rng, n_frames, hexes), lead_frames=2)
    soft = np.clip(np.round(
        (2.0 * bits - 1 + rng.normal(0, sigma, bits.shape)) * 100 + 128),
        0, 255)
    if lead is None:
        lead = int(rng.integers(0, FRAME))
    soft = np.concatenate([rng.integers(0, 256, lead).astype(np.float64),
                           soft])
    if invert_arm is not None:
        soft[invert_arm::2] = 255 - soft[invert_arm::2]
    if dropout is not None:
        a, n = dropout
        soft[lead + a:lead + a + n] = rng.integers(0, 256, n)
    return soft.astype(np.float32)


def feed_round(framers: dict, streams: dict, pos: int, block: int,
               slip: int = 0) -> list:
    """Feed every framer its stream's next ``block`` soft bits from
    ``pos`` (with ``slip`` on each), in topic order; returns the events
    the feeds returned, in that order."""
    evs = []
    for t, f in framers.items():
        evs += f.feed(streams[t][pos:pos + block], slip=slip)
    return evs
