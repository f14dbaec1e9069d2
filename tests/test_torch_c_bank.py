"""The batched C-channel bank (``protocol/batch_c_framing.py``) against the
sequential ``CChannelFramer`` it defers.

Several VFOs' noisy C streams (``tests/torch_c_streams.py``) go, drain by
drain, to sequential framers in topic order and to a bank's ``feed``.
After every drain both give equal ``CFrameEvent``s (frame index,
signalling, voice, UW errors), per topic and in cut order, the same
``on_voice(data, hex)`` and call-progress calls in the same order, and
the same framer state:
trellis history (``viterbi._carry``), buffer, lock, frame index, arm
flips and hex.  The cases: noise alone; an inverted arm; a call-progress
hex that changes mid-stream; a dropout that loses the lock and finds it
again; slips; two frames of a VFO in one drain; a lock lost and found
again inside one drain.  On the CPU the bank decodes with the native
host decoder; one case runs it on the CUDA kernel's plain-torch twin, on
a short stream, as the kernel's oracle.  The bank on the card:
tests/test_torch_cuda.py.
"""

import contextlib

import numpy as np
import pytest

from aero_tpu_torch import native
from aero_tpu_torch.protocol.batch_c_framing import (ROW,
                                                     BatchCChannelFramerBank,
                                                     _gather)
from aero_tpu_torch.protocol.c_framing import CChannelFramer
from aero_tpu_torch.protocol.interleaver import (deinterleave_indices,
                                                 depuncture_soft)
from torch_c_streams import FRAME, c_frames, c_stream, feed_bank, feed_round

TOPICS = ("C00", "C01", "C02")
HEXES = (b"\x12\x34\x56", b"\xab\xcd\xef")

# case -> (per-VFO c_stream keywords, soft bits a drain, slips by drain)
CASES = {
    "noise": ([{}, {"sigma": 0.6}, {}], 2800, {}),
    "inverted_arm": ([{"invert_arm": 1}, {"invert_arm": 0}, {}], 2800, {}),
    "call_progress_hex": ([{"hexes": HEXES}] * 3, 2800, {}),
    "dropout_relock": ([{"dropout": (3 * FRAME + 900, 6000)}, {},
                        {"dropout": (5 * FRAME, 4500)}], 2800, {}),
    "slips": ([{}, {}, {}], 2800, {3: 1, 6: -1, 8: 1}),
    "two_frames_a_drain": ([{}, {}, {}], 9000, {}),
    "relock_in_one_drain": ([{"dropout": (2 * FRAME + 600, 4000),
                              "invert_arm": 0}, {},
                             {"dropout": (3 * FRAME + 100, 5000)}],
                            36000, {}),
}


def _state(f):
    return (f.viterbi._carry.copy(), f.buf.copy(), f.locked, f.frame_index,
            f._flip.copy(), f._hex)


def _same_state(a, b, ctx):
    for x, y in zip(_state(a), _state(b)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=ctx)
        else:
            assert x == y, ctx


def _hook(f, calls, topic):
    f.on_voice = lambda data, hx: calls.append(("voice", topic, data, hx))
    f.on_call_progress = lambda su: calls.append(("progress", topic,
                                                  bytes(su)))


def _run_both(streams, block, slips, twin_patch=None):
    """Feed both sides drain by drain; returns the sequential side's
    events per drain and its sink calls (equal to the bank's)."""
    seq = {t: CChannelFramer() for t in streams}
    bank = BatchCChannelFramerBank(list(streams))
    seq_calls, bank_calls = [], []
    for t in streams:
        _hook(seq[t], seq_calls, t)
        _hook(bank.framers[t], bank_calls, t)
    rounds = []
    n = max(len(s) for s in streams.values())
    for r, pos in enumerate(range(0, n + block, block)):
        slip = slips.get(r, 0)
        want = feed_round(seq, streams, pos, block, slip)
        if twin_patch is not None:
            with twin_patch():
                got = feed_bank(bank, streams, pos, block, slip)
        else:
            got = feed_bank(bank, streams, pos, block, slip)
        assert got == want, f"drain {r}"
        assert bank_calls == seq_calls, f"drain {r}"
        for t in streams:
            _same_state(seq[t], bank.framers[t], f"drain {r} {t}")
            assert not bank.framers[t]._pending
        rounds.append(want)
    return rounds, seq_calls, seq


def test_the_gather_is_the_deinterleave_and_depuncture():
    payload = np.random.default_rng(1).integers(0, 256, 4096).astype(
        np.float32)
    soft = np.concatenate([payload[i * 256:(i + 1) * 256]
                           [deinterleave_indices(4)] for i in range(16)])
    np.testing.assert_array_equal(np.append(payload, 128.0)[_gather()],
                                  depuncture_soft(soft, 4))
    assert ROW == 2 * 2785


@pytest.mark.parametrize("case", list(CASES))
def test_the_bank_gives_the_sequential_framers_events(case):
    kws, block, slips = CASES[case]
    streams = {t: c_stream(40 + i, 7, **kw)
               for i, (t, kw) in enumerate(zip(TOPICS, kws))}
    rounds, calls, seq = _run_both(streams, block, slips)
    evs = [e for r in rounds for e in r]
    voices = [c for c in calls if c[0] == "voice"]
    # every VFO decoded frames, most of them whole
    assert len(evs) >= 15 and len(voices) == len(evs)
    assert sum(ok for e in evs for _, ok, _ in e.signalling) >= len(evs)
    if case == "inverted_arm":
        assert seq["C00"]._flip.any() or seq["C01"]._flip.any()
    if case == "call_progress_hex":
        assert {c[3] for c in voices} >= {"123456", "ABCDEF"}
    # each event gives one voice call, which names the event's VFO: the
    # frame indices of each VFO in each drain
    per_drain, k = [], 0
    for r in rounds:
        topics = [c[1] for c in voices[k:k + len(r)]]
        per_drain.append({t: [e.frame_index for u, e in zip(topics, r)
                              if u == t] for t in TOPICS})
        k += len(r)
    if case in ("dropout_relock", "relock_in_one_drain"):
        # a VFO's frame index falls back: a lock lost and found again
        assert any(_falls([i for d in per_drain for i in d[t]])
                   for t in TOPICS)
    if case == "two_frames_a_drain":
        assert max(len(v) for d in per_drain for v in d.values()) >= 2
    if case == "relock_in_one_drain":
        assert any(_falls(v) for d in per_drain for v in d.values())


def _falls(v) -> bool:
    return any(b < a for a, b in zip(v, v[1:]))


def test_the_bank_feed_gives_each_topics_events_in_cut_order():
    """``feed(rows)`` returns {topic: events}: every topic of the bank, in
    the bank's order, each with the sequential framer's events of the same
    row in the order it cut them (two frames of a VFO, and a lock lost and
    found again, inside one drain)."""
    kws, block, _ = CASES["relock_in_one_drain"]
    streams = {t: c_stream(40 + i, 7, **kw)
               for i, (t, kw) in enumerate(zip(TOPICS, kws))}
    seq = {t: CChannelFramer() for t in streams}
    bank = BatchCChannelFramerBank(list(streams))
    n = max(len(v) for v in streams.values())
    several = 0
    for pos in range(0, n + block, block):
        rows = {t: v[pos:pos + block] for t, v in streams.items()}
        got = bank.feed(rows)
        assert list(got) == list(TOPICS)
        assert got == {t: seq[t].feed(rows[t]) for t in TOPICS}, pos
        several += sum(len(evs) >= 2 for evs in got.values())
    assert several >= 2


def test_the_bank_on_the_kernels_twin(monkeypatch):
    """One VFO, three frames, decoded by the plain-torch twin of the CUDA
    kernel (the native decoder switched off for the bank alone)."""
    @contextlib.contextmanager
    def twin():
        with monkeypatch.context() as m:
            m.setattr(native, "have_native", lambda: False)
            yield

    streams = {"C00": c_stream(7, 3, lead=500, hexes=HEXES)}
    rounds, calls, _ = _run_both(streams, 5600, {}, twin_patch=twin)
    assert sum(len(r) for r in rounds) >= 3


# ---- in the fused station: the wiring and a checkpoint mid-stream ----

FS = 288000
BLOCKS = 14


@pytest.fixture(scope="module")
def cband_capture():
    """A small C-band bank on the 4x plan (a P and two C VFOs 48 kHz
    apart at 288 kS/s) with voice on both C channels, whose call-progress
    hex changes mid-stream."""
    from test_torch_cuda import cband_ini, cband_layout, cband_wideband
    from aero_tpu_torch.channelizer import load_ini
    rng = np.random.default_rng(8)
    layout = cband_layout(1, 2, 0, 48000)
    content = {t: ("C", c_frames(rng, 4, HEXES)) for t in ("C01", "C02")}
    wide = cband_wideband(FS, layout, content, BLOCKS * 96000, seed=4)
    return load_ini(cband_ini(FS, layout), is_text=True), wide


def _station(cfg, out):
    from aero_tpu_torch.runtime.fused_station import FusedStation
    return FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                        device="cpu",
                        on_voice=lambda v, d, h: out.append((v, d, h)))


def _feed(st, blocks):
    L = st.block_len
    for x in blocks:
        st.process(x)
        # every drain flushes its C frames
        assert not any(getattr(f, "_pending", ()) for f in
                       st.framers.values())
    assert L == 96000


def _stats(st):
    s = st.stats
    return (s.frames, s.su_ok, s.su_bad, s.voice_frames)


def test_the_station_with_a_c_bank_resumes_from_a_checkpoint(
        cband_capture, tmp_path):
    """The fused station builds a C bank for the 8400 group (beside a P
    bank for the P group) and gives the voice and events of sequential
    ``CChannelFramer``s fed the same drained soft rows; saved mid-stream
    and restored into a new station, it gives the same voice and counts
    as an unbroken run."""
    from aero_tpu_torch.protocol.batch_c_framing import (
        DeferredCChannelFramer)
    cfg, wide = cband_capture
    blocks = [wide[b * 96000:(b + 1) * 96000] for b in range(BLOCKS)]
    out, drained = [], []
    st = _station(cfg, out)
    assert all(isinstance(st.framers[t], DeferredCChannelFramer)
               for t in ("C01", "C02"))
    assert len(st._c_banks) == 1 and len(st._batch_banks) == 1
    bank, = st._c_banks.values()

    def spy(rows, _feed=bank.feed):
        evs = _feed(rows)
        drained.append((rows, evs))
        return evs
    bank.feed = spy
    _feed(st, blocks)
    st.flush()
    stats = _stats(st)
    assert len(drained) == BLOCKS
    seq_out = []
    seq = {t: CChannelFramer(on_voice=lambda d, h, t=t: seq_out.append(
        (t, d, h))) for t in bank.framers}
    for rows, evs in drained:
        assert evs == {t: seq[t].feed(row) for t, row in rows.items()}
    assert out == seq_out
    assert len(out) >= 8 and {v for v, _, _ in out} == {"C01", "C02"}
    assert {h for _, _, h in out} >= {"123456", "ABCDEF"}

    got = []
    a = _station(cfg, got)
    _feed(a, blocks[:6])
    path = str(tmp_path / "c_bank.ckpt")
    a.save_checkpoint(path)
    assert 0 < len(got) < len(out)
    b = _station(cfg, got)
    b.load_checkpoint(path)
    _feed(b, blocks[6:])
    b.flush()
    assert got == out and _stats(b) == stats


def test_the_station_has_one_framing_path(cband_capture):
    """``batch_host_framing=False`` (the sequential framers the station
    no longer builds) raises, naming the one path."""
    cfg, _ = cband_capture
    from aero_tpu_torch.runtime.fused_station import FusedStation
    with pytest.raises(ValueError, match="one framing path"):
        FusedStation(cfg, pfb_oversample=4, batch_host_framing=False,
                     device="cpu")
