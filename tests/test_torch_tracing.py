"""The port's tracer (``aero_tpu_torch/utils/profiling.py``) on the fused
station, on the CPU.

A short fill capture on the bank of tests/torch_station_bank.py (three
1200 bps VFOs carrying fill frames, an empty 600 bps VFO that hunts, an
R burst watcher), fed block by block and flushed:

- with the tracer off, nothing is recorded and its clock is never read;
- with it on, every span has its documented parent and block, a drain's
  stages' self times and its own add up to its duration, and the
  counters agree with what the framers and the batched decode did;
- ``station_main --trace`` puts stage times and counter changes in its
  stats line, and without the flag the line is as before;
- on a small C-band bank with batched framing, each drain's batched C
  decode is a span inside the C framers', and its counters agree with
  the frames and voice out.
"""

import json

import numpy as np
import pytest
import torch
from scipy.signal import firwin, lfilter

from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.models.msk import msk_modulate
from aero_tpu_torch.protocol.batch_framing import TracedPChannelFramer
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import PChannelFramer, build_p_frames
from aero_tpu_torch.runtime import station_main
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.utils.profiling import TRACER
from torch_station_bank import CENTER, FS, INI

torch.set_num_threads(2)

# the bank plus a third 1200 bps VFO (so that a drain can decode three
# frames, padded to four) and an R burst watcher
BANK = (INI.replace("size=3", "size=5")
        + f"4\\frequency={CENTER + 96000}\n4\\data_rate=1200\n4\\topic=W\n"
        + f"5\\frequency={CENTER - 61000}\n5\\data_rate=1200\n5\\topic=R\n"
        + "5\\burst=1\n")
BLOCKS = 7

# each span's documented parents (None: a root): a framer's feed is a
# search or a preparation by its lock as it starts; a flush's rewind
# feeds a framer again within the round's bookkeeping
PARENTS = {"station.process": {None},
           "station.quantize": {"station.process"},
           "station.upload": {"station.process"},
           "station.step": {"station.process"},
           "station.drain": {"station.process", None},
           "drain.d2h": {"station.drain"},
           "drain.burst": {"station.drain"},
           "framers.search": {"station.drain", "framers.finish"},
           "framers.prepare": {"station.drain", "framers.finish"},
           "framers.decode": {"station.drain"},
           "framers.finish": {"station.drain"},
           "framers.dispatch": {"station.drain"}}


def fill_stream(delta: float, n: int, frames: int = 4) -> np.ndarray:
    """``frames`` P frames of fill SUs at 1200 bps, ``delta`` Hz from the
    centre, as torch_station_bank.p_stream places its ACARS frames."""
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    audio = msk_modulate(build_p_frames([fill * 6] * frames, 1200,
                                        lead_frames=3),
                         24000, 1200.0, freq=1000.0)
    up = FS // 24000
    x = np.zeros(len(audio) * up, np.float32)
    x[::up] = audio * up
    bb = lfilter(firwin(511, 1.0 / up), 1.0, x).astype(np.complex64)
    w = bb * np.exp(2j * np.pi * delta * np.arange(len(bb)) / FS)
    return np.concatenate([w.astype(np.complex64)[:n],
                           np.zeros(max(0, n - len(w)), np.complex64)])


@pytest.fixture(scope="module")
def capture():
    n = BLOCKS * 384000
    rng = np.random.default_rng(3)
    wb = sum(fill_stream(d, n, f) for d, f in ((24000, 4), (-24000, 5),
                                               (96000, 3)))
    wb += (rng.normal(0, 0.003, n)
           + 1j * rng.normal(0, 0.003, n)).astype(np.complex64)
    return wb


@pytest.fixture
def tracer():
    TRACER.take()
    yield TRACER
    TRACER.on = False
    TRACER.take()


def _run(wb, spy=None):
    st = FusedStation(load_ini(BANK, is_text=True), ingest_dtype="int4",
                      batch_host_framing=True, device="cpu")
    if spy is not None:
        spy(st)
    L = st.block_len
    assert len(wb) == BLOCKS * L
    for i in range(BLOCKS):
        st.process(wb[i * L:(i + 1) * L])
    st.flush()
    return st


def test_off_records_nothing_and_reads_no_clock(capture, tracer,
                                                monkeypatch):
    reads = []
    monkeypatch.setattr(tracer, "clock", lambda: reads.append(1) or 0)
    st = _run(capture)
    assert st.stats.frames > 0
    assert reads == []
    rec = tracer.take()
    assert len(rec) == 0 and rec.counts == {}
    # the plain objects: no wrapper stands between a call and its work
    assert type(st.framers["X"]) is PChannelFramer
    assert not {"process", "quantize", "_run_block", "_drain"} & set(
        vars(st))
    assert "process" not in vars(st.burst_demods["R"])


@pytest.fixture(scope="module")
def traced(capture):
    """One traced run: the station, its records, and each batched decode
    call's real and launched rows."""
    TRACER.take()
    TRACER.on = True
    calls, searched = [], []
    correlate = PChannelFramer._correlate_uw

    def counted(self, hard):
        searched.append(len(hard))
        return correlate(self, hard)
    PChannelFramer._correlate_uw = counted

    def spy(st):
        for bank in st._batch_banks.values():
            def decode(soft, prefixes, _d=bank._decode, _b=bank, **kw):
                calls.append((sum(len(f._pending)
                                  for f in _b.framers.values()),
                              soft.shape[0]))
                return _d(soft, prefixes, **kw)
            bank._decode = decode
    try:
        st = _run(capture, spy)
        rec = TRACER.take()
    finally:
        PChannelFramer._correlate_uw = correlate
        TRACER.on = False
        TRACER.take()
    return st, rec, (calls, searched)


def test_spans_have_their_parents_and_blocks(traced):
    st, rec, _ = traced
    assert type(st.framers["X"]) is TracedPChannelFramer
    names = {rec.label(i) for i in range(len(rec))}
    assert names == set(PARENTS), names ^ set(PARENTS)
    for i in range(len(rec)):
        p = rec.parent[i]
        parent = rec.label(p) if p >= 0 else None
        assert parent in PARENTS[rec.label(i)], (rec.label(i), parent)
        if p >= 0 and rec.label(i) != "station.drain":
            # a stage serves its parent's block
            assert rec.block[i] == rec.block[p]
        assert rec.calls[i] >= 1 and rec.start[i] <= rec.end[i]
    blocks = {n: sorted(rec.block[i] for i in range(len(rec))
                        if rec.label(i) == n) for n in PARENTS}
    for n in ("station.process", "station.quantize", "station.upload",
              "station.step", "station.drain", "drain.d2h"):
        assert blocks[n] == list(range(BLOCKS)), n
    # the pipeline drains a block two blocks after it was fed, and the
    # flush drains the last two
    for i in range(len(rec)):
        if rec.label(i) == "station.drain":
            p = rec.parent[i]
            assert rec.block[i] == (rec.block[p] - 2 if p >= 0
                                    else rec.block[i])
    assert sum(rec.parent[i] < 0 for i in range(len(rec))
               if rec.label(i) == "station.drain") == 2
    assert rec.counts["blocks.in"] == rec.counts["blocks.drained"] == BLOCKS


def _subtree_self(rec, root: int) -> int:
    kids = {}
    for i in range(len(rec)):
        kids.setdefault(rec.parent[i], []).append(i)
    todo, total = [root], 0
    while todo:
        i = todo.pop()
        total += rec.self_ns(i)
        todo += kids.get(i, [])
    return total


def test_a_drains_self_times_add_up_to_its_duration(traced):
    _, rec, _ = traced
    drains = [i for i in range(len(rec)) if rec.label(i) == "station.drain"]
    assert len(drains) == BLOCKS
    for i in drains:
        assert rec.self_ns(i) >= 0
        assert _subtree_self(rec, i) == rec.total[i]
    for i in range(len(rec)):
        if rec.label(i) == "station.process":
            assert _subtree_self(rec, i) == rec.total[i]
    # the stages, summed: every stage of a drain has a share
    st = rec.stages()
    for n in ("framers.search", "framers.prepare", "framers.decode",
              "framers.finish", "framers.dispatch", "drain.burst"):
        assert st[n][0] > 0 and st[n][2] >= 1, n


def test_counters_agree_with_the_framers(traced):
    st, rec, (calls, searched) = traced
    c = rec.counts
    framers = [f for bank in st._batch_banks.values()
               for f in bank.framers.values()]
    assert c["uw.locks"] == sum(f._lock_gen for f in framers) >= 3
    assert c["frames.cut"] == c["decode.rows"] == sum(n for n, _ in calls)
    assert st.stats.frames == c["decode.rows"] - c.get("frames.rewound", 0)
    assert c["decode.calls"] == len(calls)
    assert c["decode.rows_launched"] == sum(m for _, m in calls)
    for n, m in calls:
        assert m == 1 << (n - 1).bit_length()
    assert any(m > n for n, m in calls), calls
    assert c["uw.searches"] == len(searched) >= c["uw.locks"]
    assert c["uw.bits"] == sum(searched)


def test_burst_counters_in_the_station(traced):
    """Each drained block scans each burst watcher once; the capture holds
    no burst, so the host loop runs on few of them (the filterbank's
    start-up transient can make a candidate)."""
    st, rec, _ = traced
    c = rec.counts
    assert c["burst.scans"] == c["blocks.drained"] * len(st.burst_demods)
    assert c.get("burst.scans_host", 0) < c["burst.scans"] / 2


def test_burst_counters_count_scans_and_host_scans(tracer):
    """A burst watcher alone, over noise and three R bursts: ``burst.scans``
    counts every ``process`` and ``burst.scans_host`` the blocks with a
    candidate detection, as the host loop of tests/torch_burst_oracle.py
    finds them."""
    from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
    from aero_tpu_torch.protocol.rt_framing import build_r_burst
    from torch_burst_oracle import HostLoop
    fs, fb, blocks = 24000.0, 1200.0, 16
    info = (bytes([0x1B, 0x28, 0x0A, 0x0B, 0x0C, 0x77]) + b"COUNTED"
            ).ljust(17, b"\0")
    burst = msk_modulate(build_r_burst(info, preamble_bits=96), fs, fb,
                         freq=fs / 4.0 + 30.0, amplitude=0.3)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.3 / np.sqrt(20), blocks * 16000).astype(np.float32)
    for start in (40000, 130000, 190000):
        x[start:start + len(burst)] += burst
    tracer.on = True
    dm = BurstMskDemodulator(fs, fb, device="cpu")
    oracle = HostLoop(BurstMskDemodulator(fs, fb, device="cpu"))
    with_candidates = windows = 0
    for i in range(0, len(x), 16000):
        n_ring = len(oracle._ring) + 16000
        windows += sum(o["burst"] for o in dm.process(x[i:i + 16000]))
        oracle.process(x[i:i + 16000])
        with_candidates += oracle.candidates(n_ring) > 0
    counts = tracer.take().counts
    assert windows == 3
    assert counts["burst.scans"] == blocks
    assert counts["burst.scans_host"] == with_candidates
    assert 3 <= with_candidates < blocks


def test_take_keeps_an_open_span_whole(tracer, monkeypatch):
    t = iter(range(0, 100, 10))
    monkeypatch.setattr(tracer, "clock", lambda: next(t))
    tracer.on = True
    with tracer.span("station.process", 4):
        with tracer.span("framers.search"):
            pass
        first = tracer.take()
        with tracer.span("framers.search"):
            pass
    second = tracer.take()
    assert [first.label(i) for i in range(len(first))] == [
        "station.process", "framers.search"]
    assert first.calls[0] == 0 and first.total[1] == 10
    i = [second.label(j) for j in range(len(second))].index(
        "station.process")
    assert second.total[i] == 50 and second.child[i] == 20
    assert second.block[i] == 4 and second.start[i] == 0


@pytest.fixture
def cli_files(tmp_path, capture):
    ini = tmp_path / "bank.ini"
    ini.write_text(BANK)
    iq = tmp_path / "fill.cf32"
    capture.tofile(iq)
    return ["-c", str(ini), "--iq-file", str(iq), "--device", "cpu",
            "--batch-framing", "--ingest-dtype", "int4", "--format",
            "jsondump", "--stats-every", "0"]


def _stats(err: str) -> list:
    return [json.loads(line)["stats"] for line in err.splitlines()
            if line.startswith('{"stats"')]


def test_station_main_trace_puts_stage_times_in_the_stats_line(
        cli_files, capsys, tracer):
    assert station_main.main(cli_files) == 0
    plain = _stats(capsys.readouterr().err)
    assert plain and all(list(s) == [
        "wideband_samples", "realtime_factor", "frames", "su_ok", "su_bad",
        "acars", "burst_windows", "burst_packets"] for s in plain)
    assert station_main.main(cli_files + ["--trace"]) == 0
    assert not tracer.on
    traced = _stats(capsys.readouterr().err)
    assert len(traced) == len(plain)
    for s in traced:
        assert list(s)[:-1] == list(plain[0]) and list(s)[-1] == "trace"
    tr = traced[-1]["trace"]
    # the whole capture in one chunk: one stats line, after the blocks
    # that left the pipeline before the flush
    assert tr["blocks"] == BLOCKS - 2
    assert tr["counts"]["blocks.in"] == BLOCKS
    assert tr["counts"]["uw.locks"] >= 3
    assert tr["counts"]["burst.scans"] == BLOCKS - 2
    assert {"station.process", "station.drain", "framers.search",
            "framers.prepare", "framers.decode", "framers.finish",
            "framers.dispatch", "drain.burst"} <= set(tr["self_ms"])
    assert all(v >= 0 for v in tr["self_ms"].values())


def test_station_main_trace_splits_out_the_c_framers(tmp_path, capsys,
                                                     tracer):
    """A C-band bank on the 4x filterbank plan (two P, two C and a T
    watcher at 288 kS/s, voice on a C channel): the C channels' framers
    are a ``framers.c`` span in the drain, their frames and the voice
    frames out are counted."""
    from aero_tpu_torch.protocol.crc import append_crc16_bytes as crc
    from test_torch_cuda import cband_ini, cband_layout, cband_wideband
    fs = 288000
    layout = cband_layout(2, 2, 1, 48000)
    rng = np.random.default_rng(6)
    cframes = [([crc(bytes([0x30]) + bytes(rng.integers(0, 256, 9).tolist()))
                 for _ in range(3)], bytes(rng.integers(0, 256, 300).tolist()))
               for _ in range(6)]
    wide = cband_wideband(fs, layout, {"P00": ("P", ["TRACE C"]),
                                       "C02": ("C", cframes)},
                          12 * 96000, seed=2)
    ini, iq, voice = (tmp_path / "c.ini", tmp_path / "c.cf32",
                      tmp_path / "voice.bin")
    ini.write_text(cband_ini(fs, layout))
    wide.tofile(iq)
    assert station_main.main(
        ["-c", str(ini), "--iq-file", str(iq), "--device", "cpu",
         "--batch-framing", "--ingest-dtype", "int4", "--pfb-oversample",
         "4", "--voice-out", str(voice), "--stats-every", "0",
         "--trace"]) == 0
    tr = _stats(capsys.readouterr().err)[-1]["trace"]
    assert tr["self_ms"]["framers.c"] > 0
    # the stats line comes before the flush's drains
    n_voice = voice.stat().st_size // 300
    assert 4 <= tr["counts"]["voice.frames"] <= n_voice
    # each C frame decoded gives its voice frame
    assert tr["counts"]["c.frames"] == tr["counts"]["voice.frames"]


def test_the_c_bank_decode_is_a_span_inside_the_c_framers(tracer):
    """A C-band bank with batched framing (a P and two C VFOs on the 4x
    plan, voice on both C): each drain that cuts C frames decodes them in
    one ``framers.c.decode`` span inside ``framers.c``, counted in
    ``c.decode.calls``; ``c.decode.rows`` counts the frames decoded, which
    ``c.frames`` and ``voice.frames`` count too, and on the CPU (the
    native decoder, row by row) no row is padding."""
    from test_torch_cuda import cband_ini, cband_layout, cband_wideband
    from torch_c_streams import c_frames
    fs, L = 288000, 96000
    layout = cband_layout(1, 2, 0, 48000)
    rng = np.random.default_rng(9)
    wide = cband_wideband(fs, layout, {t: ("C", c_frames(rng, 4))
                                       for t in ("C01", "C02")},
                          12 * L, seed=5)
    tracer.on = True
    voice = []
    st = FusedStation(load_ini(cband_ini(fs, layout), is_text=True),
                      ingest_dtype="int4", pfb_oversample=4,
                      batch_host_framing=True, device="cpu",
                      on_voice=lambda v, d, h: voice.append(v))
    for b in range(12):
        st.process(wide[b * L:(b + 1) * L])
    st.flush()
    tracer.on = False
    rec = tracer.take()
    c = rec.counts
    dec = [i for i in range(len(rec)) if rec.label(i) == "framers.c.decode"]
    assert dec and all(rec.label(rec.parent[i]) == "framers.c" for i in dec)
    # one decode in each drain that decoded any (a record per block)
    assert all(rec.calls[i] == 1 for i in dec)
    assert c["c.decode.calls"] == len(dec) == len({rec.block[i]
                                                   for i in dec})
    assert len(voice) >= 6
    assert (c["c.decode.rows"] == c["c.decode.rows_launched"]
            == c["c.frames"] == c["voice.frames"] == len(voice))
