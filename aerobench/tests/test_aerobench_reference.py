"""The reference and the yardstick are right: the plain step equals the
port's step where both run the same arithmetic (the CPU), the plain
Viterbi equals the port's plain twin, and the roofline arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aerobench import check, roofline, run, traffic
from aerobench.ref import viterbi as ref_viterbi
from aerobench.ref.step import quantize
from conftest import tiny_cband, tiny_lband


@pytest.mark.parametrize("make", [tiny_lband, tiny_cband])
def test_reference_step_equals_the_port_step_on_the_cpu(make):
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation
    cfg, mix = make()
    mix["capture_blocks"] = 48 if cfg["vfos"][0]["data_rate"] == 1200 else 96
    tr = traffic.make(cfg, mix, 5, "cpu")
    st = FusedStation(load_ini(traffic.ini_text(cfg), is_text=True),
                      ingest_dtype="int4", batch_host_framing=True,
                      device="cpu")
    vfos = [(v.topic, v.offset_hz, v.data_rate, v.burst)
            for v in traffic.bank(cfg)]
    ref = run.reference_of(cfg)(vfos, cfg["sample_rate"], "int4",
                                device="cpu")
    assert ref.packed_len == st._packed_len
    L = tr.block_len
    s_prog, s_ref = st._init_state(), ref.init_state()
    pairs = []
    for b in range(3):
        x = tr.iq[b * L:(b + 1) * L]
        q = torch.from_numpy(st.quantize(x))
        assert np.array_equal(q.numpy(), quantize(x, "int4"))
        s_prog, p_prog = st._step(s_prog, q, torch.tensor(1.0))
        s_ref, p_ref = ref.step(s_ref, x)
        pairs.append((p_prog.numpy(), p_ref.numpy()))
    nums = check.compare_packed(ref, pairs)
    assert nums == {"soft_mad": 0.0, "soft_off": 0.0, "audio_mad": 0.0,
                    "tel_rel": 0.0, "flags": 0}
    # and from a copy of the station's state, as a run's window starts
    adopted = ref.adopt(s_prog)
    x = tr.iq[3 * L:4 * L]
    _, p_prog = st._step(s_prog, torch.from_numpy(st.quantize(x)),
                         torch.tensor(1.0))
    _, p_ref = ref.step(adopted, x)
    assert np.array_equal(p_prog.numpy(), p_ref.numpy())


def test_compare_packed_sees_a_changed_byte():
    cfg, _ = tiny_lband()
    vfos = [(v.topic, v.offset_hz, v.data_rate, v.burst)
            for v in traffic.bank(cfg)]
    ref = run.reference_of(cfg)(vfos, cfg["sample_rate"], "int4",
                                device="cpu")
    a = np.full(ref.packed_len, 128, np.uint8)
    b = a.copy()
    b[0] = 140
    nums = check.compare_packed(ref, [(a, b)])
    assert nums["soft_mad"] > 0 and nums["soft_off"] > 0


@pytest.mark.parametrize("B,T", [(1, 40), (5, 129), (3, 631)])
def test_plain_viterbi_equals_the_port_twin(B, T):
    from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
    soft = np.random.default_rng(T).integers(0, 256, (B, 2 * T))
    want = viterbi_decode_soft(torch.from_numpy(soft.astype(np.float32)))
    assert np.array_equal(ref_viterbi.decode(soft), want.numpy())


@pytest.mark.parametrize("rate", [1200, 10500])
def test_plain_frame_decode_equals_the_port_batched_decode(rate):
    from aero_tpu_torch.protocol.batch_framing import batch_decode_p_frames
    rng = np.random.default_rng(rate)
    P = ref_viterbi.PAYLOAD[rate]
    soft = rng.integers(0, 256, (4, P)).astype(np.uint8)
    pre = rng.integers(0, 256, (4, 62)).astype(np.uint8)
    got = batch_decode_p_frames(torch.from_numpy(soft), torch.from_numpy(pre),
                                rate=rate, pre_deinterleaved=True)
    info, ok = ref_viterbi.decode_p_frames(soft, pre, rate)
    assert np.array_equal(info, got["info_bits"].numpy())
    assert np.array_equal(ok, got["su_ok"].numpy())


@pytest.mark.parametrize("rate,flips", [(1200, (True,)),
                                        (10500, (False, True))])
def test_a_frame_cut_from_the_stream_decodes_to_its_infofield(rate, flips):
    from aerobench import tx
    rng = np.random.default_rng(rate)
    S = tx.p_sus_per_frame(rate)
    fields = [b"".join(tx.with_crc(bytes(rng.integers(0, 256, 10).tolist()))
                       for _ in range(S)) for _ in range(3)]
    soft = 255.0 * tx.p_stream(fields, rate).astype(np.float32)
    fb = tx.p_frame_bits(rate)
    rep = tx.P_SPECS[rate][4]
    for arm, flip in enumerate(flips):   # a carrier locked on another arm
        if flip:
            soft[arm::rep] = 255.0 - soft[arm::rep]
    # frame 1 of the stream, after the UW that closes frame 0, its
    # polarity read from that UW
    L = 32 * rep
    got = check.uw_flips(soft[fb - L:fb], rate)
    assert [bool(x) for x in got] == list(flips)
    prev = check.frame_payload(soft[0:fb], rate, got)
    row = check.frame_payload(soft[fb:2 * fb], rate, got)
    info, ok = ref_viterbi.decode_p_frames(row[None], prev[None, -62:], rate)
    assert ok.all()
    want = tx.bits_lsb(fields[1])
    assert np.array_equal(info[0, :len(want)], want)


def test_a_frame_is_found_by_its_bytes_and_a_late_one_missing_counts():
    rng = np.random.default_rng(7)
    fb = 1200
    s = rng.integers(0, 256, 4 * fb).astype(np.float32)
    ends = check._ends(s, s[2 * fb - 64:2 * fb])
    assert 2 * fb in ends
    streams = {10: ({"V0": s}, {"V0": s}, 3, 4)}
    info = np.zeros((1, 576), np.uint8)
    ok = np.zeros((1, 6), bool)
    pre = np.full((1, 62), 128.0)
    # a frame whose bytes are nowhere in the stream, drained late enough
    # that the stream must hold it
    other = rng.integers(0, 256, fb).astype(np.float32)
    d = check.compare_decodes([(10, 1200, ["V0"], [other], pre, info, ok)],
                              streams)
    assert d["decode_unfound"] == 1 and d["frames"] == 0
    # drained first in its run of blocks, it may begin before them
    early = {10: ({"V0": s}, {"V0": s}, 0, 4)}
    d = check.compare_decodes([(10, 1200, ["V0"], [other], pre, info, ok)],
                              early)
    assert d["decode_unfound"] == 0


def test_roofline_arithmetic():
    ops, nbytes = roofline.viterbi_work([(34, 631), (1, 160)])
    n = 34 * 631 + 160
    assert ops == 262 * n and nbytes == 3 * n
    kind = "NVIDIA H100 80GB HBM3"
    peak = roofline.PEAKS[kind]["int32_ops"]
    assert peak == pytest.approx(16.727e12, rel=1e-4)
    # the least time over the time taken: half the time -> 50%
    t = ops / peak
    assert roofline.share(ops, nbytes, 2 * t, kind) == pytest.approx(50.0)
    assert roofline.share(ops, nbytes, t, "some other card") is None
    assert roofline.share(0, 0, t, kind) is None
