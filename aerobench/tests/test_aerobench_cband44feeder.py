"""The C-band feeder-link configuration, ``cband44feeder``: the station on
the 4x filterbank plan (``station_args`` ``pfb_oversample`` 4) held to its
own reference copy, ``aerobench/ref/step_os4.py``.

On the CPU, at a tiny size as ``conftest.tiny_cband`` cuts ``cband44``:
the station's step equals the copy's byte for byte, a run is correct with
every planted item out, and a program without the keyword (the parent's)
is refused with exit 5.  On a card at the cell's size: the copy computed
with TF32 allowed is not correct.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from aerobench import check, control, run, traffic
from aerobench.ref import step_os4
from aerobench.ref.step import quantize
from aerobench.trace import Trace
from conftest import run_tiny

CELL = "cband44feeder.busy"


def tiny_feeder() -> tuple:
    """3 P, 1 C and 2 T VFOs of the feeder configuration at 288 kS/s (12
    kHz bins on the 4x plan, as at full size), 32 kHz apart as
    ``tiny_cband``'s, with the busy mix."""
    cfg = run.load_json(os.path.join(run.HERE, "configs",
                                     "cband44feeder.json"))
    cfg.update(sample_rate=288000,
               raster={"first_hz": cfg["center_frequency"] - 95000,
                       "spacing_hz": 32000},
               vfos=[{"kind": "P", "topic": "P{slot:02d}", "slots": [0, 3],
                      "data_rate": 10500},
                     {"kind": "C", "topic": "C{slot:02d}", "slots": [3, 4],
                      "data_rate": 8400},
                     {"kind": "T", "topic": "T{slot:02d}", "slots": [5, 7],
                      "data_rate": 10500}])
    mix = run.load_json(os.path.join(run.HERE, "traffic", "cband_busy.json"))
    return cfg, mix


def test_the_configuration_names_its_plan_and_reference():
    cfg = run.load_json(os.path.join(run.HERE, "configs",
                                     "cband44feeder.json"))
    assert cfg["station_args"] == {"pfb_oversample": 4}
    assert run.reference_of(cfg) is step_os4.RefStation
    fb = cfg["filterbank"]
    K = 4 * cfg["sample_rate"] // 48000
    assert (fb["K"], fb["hop"]) == (K, K // 4)
    assert fb["block_len"] == traffic.block_len(cfg)
    # cband44's bank, station, precision and limits, unchanged
    base = run.load_json(os.path.join(run.HERE, "configs", "cband44.json"))
    for k in ("source", "deployment", "sample_rate", "center_frequency",
              "raster", "vfos", "station", "precision", "limits"):
        assert cfg[k] == base[k], k


def test_the_reference_prototype_is_the_programs():
    from aero_tpu_torch.channelizer.pfb import pfb_prototype_os4
    for K in (24, 128):
        assert np.array_equal(step_os4.prototype(K), pfb_prototype_os4(K))


def test_the_reference_folds_agree_with_its_plain_form():
    rng = np.random.default_rng(3)
    K = 128
    T = (K // 4) * 64
    s_a = s_b = step_os4.init(K, "cpu")
    for _ in range(3):
        x = torch.from_numpy((rng.standard_normal(T)
                              + 1j * rng.standard_normal(T)
                              ).astype(np.complex64))
        s_a, za = step_os4.channelize(s_a, x, K)
        s_b, zb = step_os4.channelize_fused(s_b, x, K)
        assert za.shape == (K, T // (K // 4))
        peak = float(za.abs().max())
        assert float((za - zb).abs().max()) <= 2e-6 * peak
        assert torch.equal(s_a, s_b)


def test_the_station_step_equals_the_reference_byte_for_byte():
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation
    cfg, mix = tiny_feeder()
    tr = traffic.make(cfg, mix, 5, "cpu")
    st = FusedStation(load_ini(traffic.ini_text(cfg), is_text=True),
                      ingest_dtype="int4", batch_host_framing=True,
                      device="cpu", **cfg["station_args"])
    vfos = [(v.topic, v.offset_hz, v.data_rate, v.burst)
            for v in traffic.bank(cfg)]
    ref = run.reference_of(cfg)(vfos, cfg["sample_rate"], "int4",
                                device="cpu")
    assert ref.packed_len == st._packed_len
    assert ref.K == st._K and st.block_len == tr.block_len
    L = tr.block_len
    s_prog, s_ref = st._init_state(), ref.init_state()
    pairs = []
    for b in range(3):
        x = tr.iq[b * L:(b + 1) * L]
        q = torch.from_numpy(st.quantize(x))
        assert np.array_equal(q.numpy(), quantize(x, "int4"))
        s_prog, p_prog = st._step(s_prog, q, torch.tensor(1.0))
        s_ref, p_ref = ref.step(s_ref, x)
        assert np.array_equal(p_prog.numpy(), p_ref.numpy()), b
        pairs.append((p_prog.numpy(), p_ref.numpy()))
    assert check.compare_packed(ref, pairs) == {
        "soft_mad": 0.0, "soft_off": 0.0, "audio_mad": 0.0, "tel_rel": 0.0,
        "flags": 0}
    # and from a copy of the station's state, as a run's window starts
    adopted = ref.adopt(s_prog)
    x = tr.iq[3 * L:4 * L]
    _, p_prog = st._step(s_prog, torch.from_numpy(st.quantize(x)),
                         torch.tensor(1.0))
    _, p_ref = ref.step(adopted, x)
    assert np.array_equal(p_prog.numpy(), p_ref.numpy())


def test_a_tiny_run_is_correct_with_every_planted_item_out():
    out, info = run_tiny(*tiny_feeder(), seconds=3.0)
    assert out["correct"], info
    assert out["attempted"] > 0 and out["failed"] == 0
    assert not info["missing_by"]
    assert info["outputs"]["voice"] > 0 and info["outputs"]["packets"] > 0
    assert info["outputs"]["acars"] > 0


def test_a_program_without_the_plan_is_refused_and_the_run_exits_5(
        monkeypatch, capsys):
    from aero_tpu_torch.runtime import fused_station
    plan_init = fused_station.FusedStation.__init__

    def parent_init(self, cfg, on_acars=None, on_voice=None,
                    station_id="AERO-TPU", ingest_dtype="int16", gain=10.0,
                    pipeline=True, pipeline_depth=2, blocks_per_step=1,
                    base_block=16000, hunt=True, hunt_max_tries=6,
                    aircraft_db=None, batch_host_framing=False,
                    device="cuda"):
        # the parent's constructor: every keyword but pfb_oversample
        plan_init(self, cfg, on_acars, on_voice, station_id, ingest_dtype,
                  gain, pipeline, pipeline_depth, blocks_per_step,
                  base_block, hunt, hunt_max_tries, aircraft_db,
                  batch_host_framing, device=device)

    def fake_run_cell(cell, cfg, *args):
        run.build_station(cfg, None, None, "cpu")
        raise AssertionError("the station was built")

    monkeypatch.setattr(fused_station.FusedStation, "__init__", parent_init)
    monkeypatch.setattr(run, "run_cell", fake_run_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", CELL, "--seed", "1297273675",
                   "--seconds", "1", "--trace", "0"])
    got = capsys.readouterr()
    assert rc == 5 and got.out == ""
    assert "aerobench: the program cannot build configuration " \
        "cband44feeder: " in got.err and "pfb_oversample" in got.err


def test_a_plan_the_program_lacks_is_refused():
    cfg, _ = tiny_feeder()
    cfg["station_args"] = {"pfb_oversample": 3}
    with pytest.raises(run.Refused, match="pfb_oversample"):
        run.build_station(cfg, None, None, "cpu")


@pytest.mark.parametrize("conf,mix_name", [("cband44feeder", "cband_busy")])
def test_the_tf32_control_is_not_correct_on_the_card(card, conf, mix_name):
    cfg = run.load_json(os.path.join(run.HERE, "configs", conf + ".json"))
    mix = run.load_json(os.path.join(run.HERE, "traffic",
                                     mix_name + ".json"))
    for seed in (11, 12, 13):
        nums = control.readings(cfg, mix, seed, "tf32", card)
        assert control.fails(nums, cfg["limits"]), (seed, nums)


def test_filterbank_pct_sums_only_its_named_kernels():
    read = run.reader("filterbank_pct")
    fold, fft = read.__globals__["NAMES"]
    tr = Trace(kind="NVIDIA H100 80GB HBM3", busy_s=0.5, kernel_s={
        fold: 0.02, fft: 0.005,
        # the demodulators' convolutions and FFTs, and a name that only
        # contains the fold's
        "void at::native::(anonymous namespace)::conv_depthwise2d_forward_"
        "kernel_generic<float, int>(...)": 0.1,
        "void vector_fft<8192u, EPT<32u>, 1u, 3u>(...)": 0.1,
        "void regular_fft_factor<128u, EPT<16u>, 32u, 0u>(...)": 0.1,
        fold + " ": 0.1})
    assert read(tr, {}) == pytest.approx(100.0 * 0.025 / 0.5)
    assert read(Trace(kind=tr.kind, busy_s=0.5,
                      kernel_s={"memcpy32_post": 0.1}), {}) is None
    assert read(Trace(kind=tr.kind), {}) is None
