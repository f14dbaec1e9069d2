"""P framers that read an OQPSK arm's polarity from every frame's UW.

``aero_tpu_torch/protocol/framing.py`` was a verbatim copy of
``aero_tpu/protocol/framing.py``; it departs from it in one place.  The
reference reads each arm's polarity from the UW it locks on and keeps it
while the lock lasts, so an OQPSK arm that flips under a held lock (the
carrier slipping to another lock point) fails every SU's CRC from then
on.  The port reads the polarity again from each frame's trailing UW for
the frame after it.

1. On streams without such a flip (every rate, every starting polarity,
   noise, a gap that loses the lock, a slip), the port's framer gives
   the reference's events, field for field, and its batched bank the
   reference's bank's.
2. On a 10500 bps stream whose arm flips in the middle of a frame, the
   reference loses every SU after the flip and the port only that
   frame's, sequential and batched; the traced framer counts the frame
   whose UW turned the arm in ``frames.reflipped``.  MSK framers (one
   arm) keep the reference's behaviour.
"""

import numpy as np
import pytest
import torch

from aero_tpu.protocol import batch_framing as ref_batch
from aero_tpu.protocol import framing as ref_framing
from aero_tpu_torch.protocol import batch_framing, framing
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)


def _fields(rate, n, rng):
    n_su = framing.FRAME_SPECS[rate].payload_info_bits // 96
    return [b"".join(append_crc16_bytes(bytes(rng.integers(0, 256, 10)
                                              .tolist()))
                     for _ in range(n_su)) for _ in range(n)]


def _soft(bits, rng, noise=0.0):
    s = np.where(bits > 0, 220.0, 36.0) + noise * rng.standard_normal(
        len(bits))
    return np.clip(np.round(s), 0, 255).astype(np.float32)


def _flip_arms(soft, rate, arms, start=0):
    rep = framing.FRAME_SPECS[rate].uw_repeat
    out = soft.copy()
    for a in arms:
        idx = np.arange(start + ((a - start) % rep), len(out), rep)
        out[idx] = 255.0 - out[idx]
    return out


def _feed(framer, soft, chunk=777):
    evs = []
    for i in range(0, len(soft), chunk):
        evs += framer.feed(soft[i:i + chunk])
    return evs


def _key(ev):
    return (ev.frame_index, ev.infofield, list(map(bool, ev.su_crc_ok)),
            ev.frameinfo, ev.uw_errors)


def _stream(rate, case, seed):
    """Soft bytes of a stream without an arm flip under lock."""
    rng = np.random.default_rng(seed)
    fb = framing.FRAME_SPECS[rate].total_bits
    bits = framing.build_p_frames(_fields(rate, 8, rng), rate,
                                  lead_frames=2)
    if case == "clean":
        return _soft(bits, rng)
    if case == "noisy":
        return _soft(bits, rng, noise=40.0)
    if case in ("arm0", "arm1", "both"):
        arms = {"arm0": [0], "arm1": [1], "both": [0, 1]}[case]
        return _flip_arms(_soft(bits, rng), rate,
                          [a for a in arms
                           if a < framing.FRAME_SPECS[rate].uw_repeat])
    if case == "gap":
        # noise for two frames: the lock goes, and a new one comes (on
        # another polarity) in the frames after
        s = _soft(bits, rng)
        s[3 * fb:5 * fb] = rng.integers(0, 256, 2 * fb)
        s[5 * fb:] = 255.0 - s[5 * fb:]
        return s
    assert case == "slip"
    s = _soft(bits, rng)
    return np.concatenate([s[:4 * fb + 300], s[4 * fb + 302:]])


CASES = ["clean", "noisy", "arm0", "arm1", "both", "gap", "slip"]


@pytest.mark.parametrize("rate", [600, 1200, 10500])
@pytest.mark.parametrize("case", CASES)
def test_the_framer_gives_the_reference_events_without_a_flip(rate, case):
    soft = _stream(rate, case, seed=rate + CASES.index(case))
    want = [_key(e) for e in _feed(ref_framing.PChannelFramer(rate), soft)]
    got = [_key(e) for e in _feed(framing.PChannelFramer(rate), soft)]
    assert got == want
    assert want, "the stream gave no frame"


@pytest.mark.parametrize("case", ["clean", "noisy", "gap"])
def test_the_bank_gives_the_reference_bank_events_without_a_flip(case):
    rate = 10500
    streams = {f"P{i}": _stream(rate, case, seed=40 + i) for i in range(3)}
    ref = ref_batch.BatchPChannelFramerBank(rate, list(streams))
    port = batch_framing.BatchPChannelFramerBank(rate, list(streams),
                                                 device="cpu")
    n = max(len(s) for s in streams.values())
    got = {t: [] for t in streams}
    want = {t: [] for t in streams}
    for i in range(0, n, 2625):
        rows = {t: s[i:i + 2625] for t, s in streams.items()}
        for t, evs in ref.feed(rows).items():
            want[t] += [_key(e) for e in evs]
        for t, evs in port.feed(rows).items():
            got[t] += [_key(e) for e in evs]
    assert got == want
    assert all(want.values())


def _flipped_stream(seed=1):
    """A 10500 bps stream of 8 frames after 2 lead frames whose imag arm
    flips in the middle of frame 4's payload; (soft, the index of the
    frame that holds the flip among the framer's events)."""
    rate = 10500
    spec = framing.FRAME_SPECS[rate]
    rng = np.random.default_rng(seed)
    bits = framing.build_p_frames(_fields(rate, 8, rng), rate,
                                  lead_frames=2)
    soft = _soft(bits, rng)
    fb = spec.total_bits
    at = 4 * fb + spec.header_bits + spec.dummy_bits + 1000
    # the framer locks on lead frame 0's UW, so frame 4 of the stream is
    # its event 3
    return _flip_arms(soft, rate, [0], start=at), 3


def _su_ok(evs):
    return [all(e.su_crc_ok) for e in evs]


def test_an_arm_that_flips_under_lock_costs_the_reference_every_frame():
    soft, k = _flipped_stream()
    ref = _su_ok(_feed(ref_framing.PChannelFramer(10500), soft))
    port = _su_ok(_feed(framing.PChannelFramer(10500), soft))
    assert len(ref) == len(port) >= k + 4
    # before the flip both decode every SU; the frame that holds it fails
    assert ref[:k] == port[:k] == [True] * k
    assert not ref[k] and not port[k]
    # after it: the reference keeps the lock's polarity, the port reads
    # the UW in front of each frame
    assert not any(ref[k + 1:])
    assert all(port[k + 1:])


def test_the_bank_reads_each_frames_polarity_too():
    soft, k = _flipped_stream(seed=2)
    streams = {"P0": soft, "P1": _stream(10500, "clean", seed=9)}
    banks = {"ref": ref_batch.BatchPChannelFramerBank(10500, list(streams)),
             "port": batch_framing.BatchPChannelFramerBank(
                 10500, list(streams), device="cpu")}
    evs = {name: {t: [] for t in streams} for name in banks}
    n = max(len(s) for s in streams.values())
    for i in range(0, n, 2625):
        rows = {t: s[i:i + 2625] for t, s in streams.items()}
        for name, bank in banks.items():
            for t, e in bank.feed(rows).items():
                evs[name][t] += e
    ref, port = _su_ok(evs["ref"]["P0"]), _su_ok(evs["port"]["P0"])
    assert ref[:k] == port[:k] == [True] * k
    assert not any(ref[k + 1:]) and all(port[k + 1:])
    assert _su_ok(evs["port"]["P1"]) == _su_ok(evs["ref"]["P1"])


def test_the_traced_framer_counts_the_frames_it_reflipped():
    soft, _ = _flipped_stream()
    TRACER.take()
    TRACER.on = True
    try:
        _feed(batch_framing.TracedPChannelFramer(10500), soft)
        _feed(batch_framing.TracedPChannelFramer(10500),
              _stream(10500, "noisy", seed=3))
    finally:
        TRACER.on = False
        counts = TRACER.take().counts
    assert counts["frames.reflipped"] == 1
    assert counts["frames.cut"] > 10


def test_an_msk_framer_keeps_the_lock_polarity():
    # one arm: a polarity flip under lock is not re-read (the MSK
    # framers' behaviour is the reference's)
    rate = 1200
    rng = np.random.default_rng(4)
    bits = framing.build_p_frames(_fields(rate, 6, rng), rate,
                                  lead_frames=2)
    fb = framing.FRAME_SPECS[rate].total_bits
    soft = _soft(bits, rng)
    soft[3 * fb + 500:] = 255.0 - soft[3 * fb + 500:]
    want = [_key(e) for e in _feed(ref_framing.PChannelFramer(rate), soft)]
    assert [_key(e) for e in _feed(framing.PChannelFramer(rate),
                                   soft)] == want
