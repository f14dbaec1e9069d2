"""``correct`` comes out false when the timed path is broken underneath,
and for the control.

The runs skip the harness's look for a card (they call ``run_cell`` on
the CPU at a tiny size) and break the station for each fault a cell can
have: a step that returns its state unchanged, half of the batch (the
VFOs) left out, a framer that deinterleaves wrong, an answer altered
where it is produced.  The exchange
between chips has no cell: every cell takes one card.

The control, the reference in the station's place with TF32 allowed,
runs on a card at each cell's own size (``card``); TF32 exists only
there.
"""

from __future__ import annotations

import os

import pytest

from aerobench import control, run
from conftest import run_tiny, tiny_cband, tiny_lband


def _patch_step(monkeypatch, fn):
    from aero_tpu_torch.runtime.fused_station import FusedStation
    orig = FusedStation._shard_step

    def broken(self, state, iq2, scale, params):
        return fn(self, state, *orig(self, state, iq2, scale, params))
    monkeypatch.setattr(FusedStation, "_shard_step", broken)


def test_a_step_that_keeps_its_state_is_not_correct(monkeypatch):
    _patch_step(monkeypatch, lambda self, state, new, packed: (state, packed))
    out, info = run_tiny(*tiny_lband())
    assert not out["correct"]
    assert out["checks"]["tel_rel"]["value"] > \
        out["checks"]["tel_rel"]["limit"] or out["failed"] > 0


def tiny_fill() -> tuple:
    """The tiny L-band bank with the fill mix: nothing planted to miss."""
    cfg, _ = tiny_lband()
    return cfg, run.load_json(os.path.join(run.HERE, "traffic",
                                           "lband_fill.json"))


@pytest.mark.parametrize("make", [tiny_lband, tiny_fill])
def test_half_the_batch_left_out_is_not_correct(monkeypatch, make):
    def half(self, state, new, packed):
        packed = packed.clone()
        for key in self._order:
            pos, per = self._soft_ofs[key]
            nb = len(self.groups[key])
            packed[pos:pos + (nb // 2 or 1) * per] = 128
        return new, packed
    _patch_step(monkeypatch, half)
    out, info = run_tiny(*make())
    assert not out["correct"]
    c = out["checks"]
    assert c["soft_mad"]["value"] > c["soft_mad"]["limit"]
    assert c["soft_off"]["value"] > c["soft_off"]["limit"]


def test_a_framer_that_deinterleaves_wrong_is_not_correct(monkeypatch):
    # the frames' bytes still come from the right place of the stream,
    # so only the decode against the reference's own bytes sees it
    import numpy as np
    from aero_tpu_torch.protocol import framing
    orig = framing.deinterleave_indices
    monkeypatch.setattr(framing, "deinterleave_indices",
                        lambda cols: np.roll(orig(cols), 1))
    out, info = run_tiny(*tiny_fill())
    assert not out["correct"]
    assert out["checks"]["decode_bits"]["value"] > 0
    assert info["decoded_frames"] > 0
    assert 0 < out["failed"] <= out["attempted"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from aero_tpu_torch.runtime.fused_station import FusedStation
    orig = FusedStation._mk_sink

    def sink(self, topic):
        emit = orig(self, topic)

        def altered(item):
            item.message = item.message[:-1] + (
                "X" if item.message[-1:] != "X" else "Y")
            emit(item)
        return altered
    monkeypatch.setattr(FusedStation, "_mk_sink", sink)
    out, info = run_tiny(*tiny_lband())
    assert not out["correct"]
    assert out["checks"]["unplanted"]["value"] > 0 and out["failed"] > 0


def test_a_dropped_voice_frame_is_not_correct(monkeypatch):
    from aero_tpu_torch.runtime.fused_station import FusedStation
    orig = FusedStation._mk_voice_sink

    def sink(self, topic):
        emit = orig(self, topic)
        n = [0]

        def dropping(data, hex_aes):
            n[0] += 1
            if n[0] % 2:
                emit(data, hex_aes)
        return dropping
    monkeypatch.setattr(FusedStation, "_mk_voice_sink", sink)
    out, info = run_tiny(*tiny_cband())
    assert not out["correct"] and out["failed"] > 0


def test_the_sound_control_reads_zero_on_the_cpu():
    cfg, mix = tiny_lband()
    nums = control.readings(cfg, mix, 3, "fp32", "cpu", warm_passes=1,
                            compare_s=2.0)
    assert nums == {"soft_mad": 0.0, "soft_off": 0.0, "audio_mad": 0.0,
                    "tel_rel": 0.0, "flags": 0}


@pytest.mark.parametrize("conf,mix_name", [("lband50", "lband_fill"),
                                           ("cband44", "cband_busy")])
def test_the_tf32_control_is_not_correct_on_the_card(card, conf, mix_name):
    cfg = run.load_json(os.path.join(run.HERE, "configs", conf + ".json"))
    mix = run.load_json(os.path.join(run.HERE, "traffic",
                                     mix_name + ".json"))
    for seed in (11, 12, 13):
        nums = control.readings(cfg, mix, seed, "tf32", card)
        assert control.fails(nums, cfg["limits"]), (seed, nums)
