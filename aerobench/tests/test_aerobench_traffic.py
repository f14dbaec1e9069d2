"""The generator plants what it says: its frozen TX code against the
port's builders, its audio against the port's modulators, and a tiny
capture through the port's station gives out exactly what it lists."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from aerobench import run, synth, traffic, tx
from conftest import run_tiny, tiny_cband, tiny_lband


def test_tx_matches_the_port_builders():
    from aero_tpu_torch.protocol import (c_framing, framing, interleaver,
                                         isu, rt_framing, viterbi)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 700).astype(np.uint8)
    assert np.array_equal(tx.conv_encode(bits), viterbi.conv_encode(bits))
    for cols in (4, 9, 78):
        assert np.array_equal(tx.deinterleave_indices(cols),
                              interleaver.deinterleave_indices(cols))
    for rows in (5, 11, 17, 50):
        assert np.array_equal(
            tx.deinterleave_msk_burst_indices(rows),
            interleaver.deinterleave_msk_burst_indices(rows))
    ud = isu.make_acars_userdata("2", "N12345", "!", "H1", "A", "HELLO 42")
    assert tx.acars_userdata("2", "N12345", "!", "H1", "A", "HELLO 42") == ud
    sus = isu.segment_isu(ud, 0x400101, 0x41)
    assert tx.segment_isu(ud, 0x400101, 0x41) == sus
    assert tx.n_acars_sus(8) == len(sus)
    info = bytes(rng.integers(0, 256, 17).tolist())
    assert np.array_equal(tx.r_burst(info),
                          rt_framing.build_r_burst(info, preamble_bits=96))
    assert np.array_equal(
        tx.t_burst(0x400101, 0x41, sus),
        rt_framing.build_t_burst(0x400101, 0x41, sus, oqpsk=True,
                                 preamble_bits=128))
    # the periodic streams equal the port's builders frame for frame,
    # but for the first few coded bits, which the tail-biting start sets
    for rate in (1200, 10500):
        nb = framing.FRAME_SPECS[rate].payload_info_bits // 8
        fields = [bytes(rng.integers(0, 256, nb).tolist()) for _ in range(3)]
        ref = framing.build_p_frames(fields, rate, lead_frames=1)
        got = tx.p_stream(fields + [bytes(nb)], rate)
        fb = tx.p_frame_bits(rate)
        assert np.array_equal(got[fb:4 * fb], ref[fb:4 * fb])
        assert np.sum(got[:fb] != ref[:fb]) <= 12
    frames = [([bytes(rng.integers(0, 256, 12).tolist()) for _ in range(3)],
               bytes(rng.integers(0, 256, 300).tolist())) for _ in range(3)]
    ref = c_framing.build_c_frames(frames, lead_frames=0)
    got = tx.c_stream(frames + [([bytes(12)] * 3, bytes(300))])
    assert np.array_equal(got, ref)


def test_msk_audio_is_the_port_modulator():
    from aero_tpu_torch.models.msk import msk_modulate
    bits = tx.r_burst(bytes(range(17)))
    want = msk_modulate(bits, 24000, 1200.0, freq=6040.0, amplitude=0.2)
    got = synth.msk_audio(bits, len(want) + 77, 24000, 1200, 6040.0, 0.2,
                          start=40).numpy()
    np.testing.assert_allclose(got[40:40 + len(want)], want, atol=1e-6)
    assert not got[:40].any()


def test_periodic_msk_closes_its_phase():
    # bits whose phase steps sum to 2 mod 4: half a cycle short of closing
    rng = np.random.default_rng(3)
    while True:
        bits = rng.integers(0, 2, 1200).astype(np.uint8)
        e = np.cumsum(bits ^ (np.arange(1200) % 2).astype(np.uint8)) % 2
        if int(np.sum(1 - 2 * e.astype(np.int64))) % 4 == 2:
            break

    def seam(a):
        # the step from the last sample to the first: a 1 kHz tone at
        # 24 kS/s moves at most 2 pi / 24 per sample
        a = a.numpy()
        return abs(float(a[0]) - float(a[-1]))
    closed = synth.msk_audio(bits, 24000, 24000, 1200, 1000.0, 1.0,
                             periodic=True)
    open_ = synth.msk_audio(bits, 24000, 24000, 1200, 1000.0, 1.0)
    assert seam(closed) < 0.3 < 1.0 < seam(open_)


@pytest.mark.parametrize("make", [tiny_lband, tiny_cband])
def test_same_seed_same_capture_and_every_seed_the_same_work(make):
    cfg, mix = make()
    a = traffic.make(cfg, mix, 2 ** 31 + 7, "cpu")
    b = traffic.make(cfg, mix, 2 ** 31 + 7, "cpu")
    c = traffic.make(cfg, mix, 99, "cpu")
    assert np.array_equal(a.iq, b.iq)
    assert [e.key for e in a.expected] == [e.key for e in b.expected]
    assert not np.array_equal(a.iq, c.iq)
    # the same work in another order: as many items of each kind on each
    # VFO, the same message lengths, the same bursts at the same times
    def work(tr):
        return sorted((e.kind, e.topic, len(e.key[1]) if e.kind == "acars"
                       else 0) for e in tr.expected)
    assert work(a) == work(c)
    assert sorted((e.topic, e.due) for e in a.expected
                  if e.kind in ("R", "T")) == sorted(
        (e.topic, e.due) for e in c.expected if e.kind in ("R", "T"))
    assert len(a.iq) == a.blocks * a.block_len


def test_every_planted_thing_comes_out_and_nothing_else():
    out, info = run_tiny(*tiny_lband())
    assert out["correct"], info
    assert out["attempted"] > 0 and out["failed"] == 0
    kinds = {k for (t, k), n in info["missing_by"]}
    assert not kinds


def test_a_fill_run_counts_its_decoded_frames_as_attempted():
    # nothing is planted to come out, so the frames decoded are the
    # answers judged one by one
    cfg, _ = tiny_lband()
    mix = run.load_json(os.path.join(run.HERE, "traffic", "lband_fill.json"))
    out, info = run_tiny(cfg, mix)
    assert out["correct"], info
    assert out["attempted"] == info["decoded_frames"] > 0
    assert out["failed"] == 0


def test_cband_voice_t_bursts_and_acars_come_out():
    cfg, mix = tiny_cband()
    out, info = run_tiny(cfg, mix, seconds=3.0)
    assert out["correct"], info
    assert info["outputs"]["voice"] > 0 and info["outputs"]["packets"] > 0
    assert out["checks"]["voice_disorder"]["value"] == 0
