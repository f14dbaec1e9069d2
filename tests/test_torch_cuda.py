"""The port on a CUDA card: the Viterbi kernel, the fused and classic
stations, and the single-VFO decoder.

These tests import no JAX (the card's machine has none) and skip where no
CUDA device is present.  On the card, from the repository root (the
``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

- the kernel is bit-exact against its plain-torch twin on uint8 soft
  bytes (integral, uniform random, extreme 0/255 and all-tie inputs; the
  frame shapes of 1200 and 10500 bps, the R/T checkpoint shapes, a few
  ragged ones and the largest T the wrapper takes), counts one launch per
  call, and rejects what it does not take (float32 soft, a bad shape, a
  T beyond one block's shared memory);
- the fused station with batch framing decodes the same ACARS on the card
  as on the CPU, through the kernel;
- one step of a small C-band station (OQPSK 10500 P, 8400 C and a burst
  10500 T watcher) on the card against the same step on the CPU, from the
  same state, within the limits of ``check_packed``;
- the classic station (tree and filterbank backends) decodes the same
  ACARS on the card as on the CPU, and ``decode_main`` on a burst capture
  prints the same records on both, its R/T decodes through the kernel;
- sharded over a mesh of two shards (two cards, or two shards of
  ``cuda:0`` on a one-card machine), the fused station with batch framing
  and the classic station decode the same ACARS on the card as the same
  station unsharded there, the fused one through the kernel, and a
  sharded fused step agrees with the unsharded one within the limits of
  ``check_packed``;
- the bench's Viterbi and demod sections (``aero_tpu_torch.bench``) time
  positive rates on the card, the Viterbi one through the kernel, whose
  decode equals the twin's and the encoded bits;
- the C channels' bank (``protocol/batch_c_framing.py``), its decode a
  graph per padded N that launches the kernel, gives the host framers'
  events, voice and trellis history on noisy streams;
- the burst watchers' detection on the card, its ring there and the host
  loop only for a block with a candidate, gives the outputs, ring and
  noise floor of the host-loop oracle (tests/torch_burst_oracle.py) over
  noise and bursts, one captured key per detection step in the steady
  state;
- the device steps as CUDA-graph replays (``utils/graphs.py``): a small
  fused station (4 blocks per step, 2 steps in flight) and a small MSK
  bank with a retune between steps give the same bytes graphed as under
  ``device.disable_graphs()``, each step captured once; a step that
  syncs with the host inside its capture raises ``CaptureError`` naming
  the step (in a child process: a failed capture may leave the CUDA
  context unusable).

``check_packed`` and the C-band bank builders below are shared with
tests/test_torch_mixed.py and chip_smoke.py (this file imports no JAX, so
both can import it).
"""

import numpy as np
import pytest
import torch

from aero_tpu_torch.device import set_fp32_precision
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
from aero_tpu_torch.runtime.fused_station import TEL_SLOTS
from torch_soft import KERNEL_KINDS, soft_bytes

torch.set_num_threads(2)


def check_packed(st, a, b):
    """Two packed step buffers of station ``st`` (uint8 numpy) agree:

    - continuous groups: soft bytes within +-1 on >= 99.9% and equal on
      >= 99% of the bytes; lock flags and slips exact; mse 1e-4 relative;
      freq 2e-3 Hz; Eb/N0 1e-3 dB or 1e-4 relative (its argument cancels
      at high SNR);
    - burst groups: the int16 audio within one LSB, its RMS and peak to
      1e-4 relative.

    Raises AssertionError; returns the worst figures seen, for a log."""
    worst = {"soft_le1": 1.0, "soft_eq": 1.0, "audio_lsb": 0,
             "mse_rel": 0.0, "ebno_db": 0.0, "freq_hz": 0.0}
    tel_a = a[st._soft_total:].view(np.float32)
    tel_b = b[st._soft_total:].view(np.float32)
    assert np.isfinite(tel_a).all() and np.isfinite(tel_b).all()
    for key in st._order:
        nb = len(st.groups[key])
        pos, per = st._soft_ofs[key]
        ba, bb = a[pos: pos + nb * per], b[pos: pos + nb * per]
        o = st._tel_ofs[key]
        ta = tel_a[o: o + TEL_SLOTS * nb].reshape(TEL_SLOTS, nb)
        tb = tel_b[o: o + TEL_SLOTS * nb].reshape(TEL_SLOTS, nb)
        if key[2]:
            d = np.abs(ba.view(np.int16).astype(np.int32)
                       - bb.view(np.int16).astype(np.int32))
            worst["audio_lsb"] = max(worst["audio_lsb"], int(d.max()))
            assert d.max() <= 1, (key, int(d.max()))
            np.testing.assert_allclose(ta[:2], tb[:2], rtol=1e-4, atol=1e-9)
            continue
        d = np.abs(ba.astype(np.int32) - bb.astype(np.int32))
        worst["soft_le1"] = min(worst["soft_le1"], float((d <= 1).mean()))
        worst["soft_eq"] = min(worst["soft_eq"], float((d == 0).mean()))
        worst["mse_rel"] = max(worst["mse_rel"], float(
            (np.abs(ta[1] - tb[1]) / np.maximum(np.abs(tb[1]), 1e-30)).max()))
        worst["ebno_db"] = max(worst["ebno_db"],
                               float(np.abs(ta[2] - tb[2]).max()))
        worst["freq_hz"] = max(worst["freq_hz"],
                               float(np.abs(ta[3] - tb[3]).max()))
        assert (d <= 1).mean() >= 0.999, (key, float((d > 1).mean()))
        assert (d == 0).mean() >= 0.99, (key, float((d == 0).mean()))
        np.testing.assert_array_equal(ta[0], tb[0])              # lock
        np.testing.assert_allclose(ta[1], tb[1], rtol=1e-4)      # mse
        np.testing.assert_allclose(ta[2], tb[2], rtol=1e-4,      # Eb/N0
                                   atol=1e-3)
        np.testing.assert_allclose(ta[3], tb[3], atol=2e-3)      # freq Hz
        np.testing.assert_array_equal(ta[4], tb[4])              # slips
    return worst


# ---- a C-band bank: OQPSK 10500 P, 8400 C and burst 10500 T VFOs ----------

CB_CENTER = 3600500000          # a downconverted 3.6 GHz feed, as in
                                # configs/cband_10500.ini


def cband_layout(n_p, n_c, n_t, spacing):
    """[(topic, offset_hz, data_rate, burst)]: n_p P, n_c C and n_t T VFOs
    ``spacing`` Hz apart, centred on the tune."""
    kinds = ([("P", 10500, False)] * n_p + [("C", 8400, False)] * n_c
             + [("T", 10500, True)] * n_t)
    n = len(kinds)
    return [(f"{k}{i:02d}", int(round((i - (n - 1) / 2) * spacing)), rate,
             burst) for i, (k, rate, burst) in enumerate(kinds)]


def cband_ini(fs, layout):
    vfos = "".join(
        f"{i + 1}\\frequency={CB_CENTER + off}\n{i + 1}\\data_rate={rate}\n"
        f"{i + 1}\\topic={topic}\n" + (f"{i + 1}\\burst=1\n" if burst else "")
        for i, (topic, off, rate, burst) in enumerate(layout))
    return (f"[General]\nsample_rate={fs}\ncenter_frequency={CB_CENTER}\n"
            f"[vfos]\nsize={len(layout)}\n{vfos}")


def content_vfos(fs, layout, kind, count):
    """The ``count`` VFOs of ``kind`` nearest their filterbank bin centres
    (bins every 24 kHz for 48 kS/s channels), so their whole band sits in
    the channel's passband."""
    bin_hz = 24000.0
    cands = [(abs(off - round(off / bin_hz) * bin_hz), topic)
             for topic, off, _, _ in layout if topic.startswith(kind)]
    return [t for _, t in sorted(cands)[:count]]


def cband_wideband(fs, layout, content, n, seed=0, noise=0.04):
    """Complex wideband IQ at ``fs`` with ``content`` on some VFOs of the
    layout, plus complex Gaussian noise on every VFO:

    - ("P", [texts]): one ACARS message per text on a 10500 P channel,
      then fill frames to the end (the carrier stays up, so no frames are
      decoded from noise);
    - ("C", cframes): C-channel frames of (signalling SUs, 300-byte
      voice), with 3 lead frames;
    - ("T", text, t0): one OQPSK T burst carrying ``text`` as ACARS,
      starting ``t0`` seconds in.

    Each audio stream is made at 48 kS/s (carrier at 8 kHz), upsampled to
    ``fs`` by resample_poly and shifted to its VFO's offset."""
    from scipy.signal import resample_poly
    from aero_tpu_torch.models.oqpsk import oqpsk_modulate
    from aero_tpu_torch.protocol.c_framing import build_c_frames
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    from aero_tpu_torch.protocol.framing import FRAME_SPECS, build_p_frames
    from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu_torch.protocol.rt_framing import build_t_burst

    rng = np.random.default_rng(seed)
    wide = (noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    up = fs // 48000
    offsets = {topic: off for topic, off, _, _ in layout}
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    per = FRAME_SPECS[10500].payload_info_bits // 96
    for k, (topic, spec) in enumerate(sorted(content.items())):
        kind = spec[0]
        if kind == "P":
            sus = []
            for text in spec[1]:
                ud = make_acars_userdata("2", f"N{k}{topic}", "!", "H1", "A",
                                         text)
                sus += [append_crc16_bytes(b)
                        for b in segment_isu(ud, 0x500000 + k, 0x41)]
            while len(sus) % per:
                sus.append(fill)
            fields = [b"".join(sus[i:i + per])
                      for i in range(0, len(sus), per)]
            frame_bits = (len(build_p_frames([fill * per] * 2, 10500, 0))
                          - len(build_p_frames([fill * per], 10500, 0)))
            fields += [fill * per] * int(n / fs * 10500 / frame_bits + 2)
            audio = oqpsk_modulate(build_p_frames(fields, 10500, 2), 48000,
                                   10500.0, amplitude=0.2)
        elif kind == "C":
            audio = oqpsk_modulate(build_c_frames(spec[1], lead_frames=3),
                                   48000, 8400.0, amplitude=0.2)
        else:
            ud = make_acars_userdata("2", f"N{k}{topic}", "!", "H1", "A",
                                     spec[1])
            bits = build_t_burst(0x500000 + k, 0x41,
                                 segment_isu(ud, 0x500000 + k, 0x41),
                                 oqpsk=True, preamble_bits=128)
            audio = np.concatenate([
                np.zeros(int(spec[2] * 48000), np.float32),
                oqpsk_modulate(bits, 48000, 10500.0, freq=8000.0,
                               amplitude=0.2)])
        bb = resample_poly(audio[: n // up + 1].astype(np.float64), up, 1)[:n]
        t = np.arange(len(bb)) / fs
        wide[: len(bb)] += (bb * np.exp(2j * np.pi * offsets[topic] * t)
                            ).astype(np.complex64)
    return wide


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    set_fp32_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("B,T", [(64, 631), (256, 2551), (1, 1), (3, 33),
                                 (5, 64), (130, 95), (2, "max")])
def test_kernel_bit_exact_vs_plain(cuda, B, T):
    if T == "max":
        T = vk.max_t(cuda)
    for kind in KERNEL_KINDS:
        soft = torch.from_numpy(soft_bytes(kind, B, T, seed=B * 7 + T)).to(
            device=cuda, dtype=torch.uint8)
        before = vk.LAUNCHES
        got = vk.viterbi_decode_soft_cuda(soft)
        torch.cuda.synchronize()
        assert vk.LAUNCHES == before + 1
        assert got.dtype == torch.uint8 and got.shape == (B, T)
        assert torch.equal(got, viterbi_decode_soft(soft)), kind


def test_kernel_rejects_what_it_does_not_take(cuda):
    soft = torch.full((4, 20), 128, dtype=torch.uint8, device=cuda)
    before = vk.LAUNCHES
    for bad in (torch.float32, torch.float64, torch.int16):
        with pytest.raises(TypeError):
            vk.viterbi_decode_soft_cuda(soft.to(bad))
    with pytest.raises(ValueError):
        vk.viterbi_decode_soft_cuda(soft[:, :19])
    with pytest.raises(ValueError):
        vk.viterbi_decode_soft_cuda(soft.t())
    # one block's shared memory holds the main path's longest R/T decode
    # (T=3040) and T=16384; one step more than the bound raises
    assert vk.max_t(cuda) >= 16384
    with pytest.raises(ValueError):
        vk.viterbi_decode_soft_cuda(torch.full(
            (1, 2 * vk.max_t(cuda) + 2), 128, dtype=torch.uint8, device=cuda))
    assert vk.LAUNCHES == before


def test_station_on_card_matches_cpu(cuda):
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation
    from torch_station_bank import INI, make_wideband

    wb = make_wideband()
    results = {}
    for dev in ("cpu", "cuda"):
        got = []
        st = FusedStation(load_ini(INI, is_text=True), ingest_dtype="int4",
                          batch_host_framing=True, device=dev,
                          on_acars=lambda v, it: got.append((v, it.message)))
        w = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
        vk.reset_launches()
        for i in range(0, len(w) - st.block_len + 1, st.block_len):
            st.process(w[i:i + st.block_len])
        st.flush()
        results[dev] = (sorted(set(got)), st.stats.frames, st.stats.su_ok,
                        st.stats.su_bad, vk.LAUNCHES > 0)
    assert ("X", "BATCH XX") in results["cuda"][0]
    assert results["cuda"][:4] == results["cpu"][:4]
    assert results["cuda"][4] and not results["cpu"][4]


@pytest.mark.parametrize("rows", [5, 11, 50, 95])
def test_kernel_bit_exact_at_rt_shapes(cuda, rows):
    """The R/T framer's checkpoint decodes: one stream (B=1) of rows*64
    soft bits (R: 5 rows, MSK T: 11 and 50, the most: 95), through the
    framer's decoder on the card."""
    T = rows * 32
    dec = vk.stream_decoder(cuda)
    for kind in KERNEL_KINDS:
        soft = soft_bytes(kind, 1, T, seed=rows)
        before = vk.LAUNCHES
        got = dec(soft[0])
        assert vk.LAUNCHES == before + 1
        assert got.dtype == np.uint8 and got.shape == (T,)
        want = viterbi_decode_soft(torch.from_numpy(soft))[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_cband_step_on_card_matches_cpu(cuda):
    from aero_tpu_torch import convert
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    from aero_tpu_torch.runtime.fused_station import FusedStation

    fs = 288000
    layout = cband_layout(2, 2, 1, 48000)
    rng = np.random.default_rng(3)
    cframes = [([append_crc16_bytes(bytes([0x30]) + bytes(
        rng.integers(0, 256, 9).tolist())) for _ in range(3)],
        bytes(rng.integers(0, 256, 300).tolist())) for _ in range(2)]
    content = {content_vfos(fs, layout, "P", 1)[0]: ("P", ["CARD STEP"]),
               content_vfos(fs, layout, "C", 1)[0]: ("C", cframes),
               content_vfos(fs, layout, "T", 1)[0]: ("T", "CARD BURST", 0.5)}
    cfg = load_ini(cband_ini(fs, layout), is_text=True)
    card = FusedStation(cfg, ingest_dtype="int4", device=cuda)
    cpu = FusedStation(cfg, ingest_dtype="int4", device="cpu")
    L = card.block_len
    wide = cband_wideband(fs, layout, content, 5 * L, seed=1)
    for b in range(4):
        card.process(wide[b * L:(b + 1) * L])
    card.flush()
    arr = card.quantize(wide[4 * L:])
    state_np = convert.fused_state_to_numpy(card._state)
    one = np.float32(1.0)
    _, gp = card._step(convert.fused_state_from_numpy(state_np, cuda),
                       torch.from_numpy(arr).to(cuda),
                       torch.tensor(one, device=cuda))
    _, cp = cpu._step(convert.fused_state_from_numpy(state_np, "cpu"),
                      torch.from_numpy(arr), torch.tensor(one))
    check_packed(card, gp.cpu().numpy(), cp.numpy())
    tel = cp.numpy()[card._soft_total:].view(np.float32)
    key = (48000, 10500, False)
    o, nb = card._tel_ofs[key], len(card.groups[key])
    assert tel[o: o + nb].sum() > 0, "no P VFO was locked at the step"


def test_cband_step_on_the_4x_plan_on_card_matches_cpu(cuda):
    """The C-band step on the 4x filterbank plan (its 4-parity fold, the
    residual mixes from the filterbank's delay, the T watcher's low-pass)
    on the card against the CPU, from a state the card carried."""
    from aero_tpu_torch import convert
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    from aero_tpu_torch.runtime.fused_station import FusedStation

    fs = 288000
    layout = cband_layout(2, 2, 2, 34000)
    rng = np.random.default_rng(4)
    cframes = [([append_crc16_bytes(bytes([0x30]) + bytes(
        rng.integers(0, 256, 9).tolist())) for _ in range(3)],
        bytes(rng.integers(0, 256, 300).tolist())) for _ in range(2)]
    content = {"P00": ("P", ["CARD PLAN"]), "C03": ("C", cframes),
               "T04": ("T", "CARD PLAN BURST", 0.5)}
    cfg = load_ini(cband_ini(fs, layout), is_text=True)
    card = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                        device=cuda)
    cpu = FusedStation(cfg, ingest_dtype="int4", pfb_oversample=4,
                       device="cpu")
    L = card.block_len
    wide = cband_wideband(fs, layout, content, 5 * L, seed=2)
    for b in range(4):
        card.process(wide[b * L:(b + 1) * L])
    card.flush()
    arr = card.quantize(wide[4 * L:])
    state_np = convert.fused_state_to_numpy(card._state)
    one = np.float32(1.0)
    _, gp = card._step(convert.fused_state_from_numpy(state_np, cuda),
                       torch.from_numpy(arr).to(cuda),
                       torch.tensor(one, device=cuda))
    _, cp = cpu._step(convert.fused_state_from_numpy(state_np, "cpu"),
                      torch.from_numpy(arr), torch.tensor(one))
    check_packed(card, gp.cpu().numpy(), cp.numpy())


@pytest.mark.parametrize("backend", ["tree", "pfb"])
def test_classic_station_on_card_matches_cpu(cuda, backend):
    """The classic station (tree channelizer or filterbank, then the demod
    banks) on the bank of tests/torch_station_bank.py: the same ACARS and
    the same frame and SU counts on the card as on the CPU, and its
    carries on the card."""
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.station import Station
    from torch_station_bank import INI, make_wideband

    cfg = load_ini(INI, is_text=True)
    B = cfg.buflen_complex
    w = np.concatenate([make_wideband(), np.zeros(4 * B, np.complex64)])
    results = {}
    for dev in ("cpu", "cuda"):
        got = []
        st = Station(cfg, backend=backend, device=dev,
                     on_acars=lambda v, it: got.append((v, it.message)))
        for i in range(0, len(w) - B + 1, B):
            st.process(w[i:i + B])
        results[dev] = (sorted(set(got)), st.stats.frames, st.stats.su_ok,
                        st.stats.su_bad)
    assert ("X", "BATCH XX") in results["cuda"][0]
    assert results["cuda"] == results["cpu"]
    assert all(b.states.freq.device.type == "cuda" for b in st.banks.values())


def test_decode_main_burst_on_card_matches_cpu(cuda, tmp_path, capsys):
    """decode_main on a burst T capture (the scenario of
    tests/test_runtime.py): the same records on the card as on the CPU,
    and the R/T framer's checkpoint decodes launch the kernel."""
    import json
    import wave
    from aero_tpu_torch.models.msk import msk_modulate
    from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu_torch.protocol.rt_framing import build_t_burst
    from aero_tpu_torch.runtime import decode_main

    sus = segment_isu(make_acars_userdata("2", "NBURST", "!", "H1", "A",
                                          "BURST ON CARD"), 0x333444, 0x41)
    a = np.concatenate([np.zeros(30000, np.float32),
                        msk_modulate(build_t_burst(0x333444, 0x41, sus,
                                                   preamble_bits=96),
                                     12000, 600, freq=3100.0, amplitude=0.3),
                        np.zeros(40000, np.float32)])
    path = tmp_path / "b.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(12000)
        f.writeframes(np.clip(a * 32767, -32767, 32767).astype("<i2")
                      .tobytes())
    records, launches = {}, {}
    for dev in ("cpu", "cuda"):
        vk.reset_launches()
        assert decode_main.main(["-b", "600", "--burst", "--input-file",
                                 str(path), "-s", "CARD", "--device",
                                 dev]) == 0
        launches[dev] = vk.LAUNCHES
        records[dev] = [{k: v for k, v in json.loads(line).items()
                         if k != "t"}
                        for line in capsys.readouterr().out.splitlines()
                        if line.startswith("{")]
    assert records["cuda"] == records["cpu"] and len(records["cuda"]) == 1
    assert records["cuda"][0]["isu"]["acars"]["reg"] == "NBURST"
    assert launches["cuda"] > 0 and launches["cpu"] == 0


def _card_mesh():
    """Two shards: the first two cards, or two shards of cuda:0 on a
    one-card machine."""
    from aero_tpu_torch.parallel.mesh import make_mesh
    if torch.cuda.device_count() >= 2:
        return make_mesh(2)
    return make_mesh(2, device="cuda:0")


def _even_bank_ini():
    """tests/torch_station_bank.py's bank with a second 600 bps VFO, so a
    mesh of two shards divides both rate groups."""
    from torch_station_bank import CENTER, INI
    return (INI.replace("size=3", "size=4")
            + f"4\\frequency={CENTER - 61000}\n4\\data_rate=600\n"
              "4\\topic=W\n")


def test_sharded_fused_station_on_card_matches_unsharded(cuda):
    from aero_tpu_torch import convert
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation
    from torch_station_bank import make_wideband

    cfg = load_ini(_even_bank_ini(), is_text=True)
    wb = make_wideband()
    results, stations = {}, {}
    for name in ("unsharded", "sharded"):
        got = []
        st = FusedStation(cfg, ingest_dtype="int4", batch_host_framing=True,
                          device=cuda,
                          on_acars=lambda v, it: got.append((v, it.message)))
        if name == "sharded":
            st.shard(_card_mesh())
            assert len(st._shards) == 2
        w = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
        vk.reset_launches()
        for i in range(0, len(w) - st.block_len + 1, st.block_len):
            st.process(w[i:i + st.block_len])
        st.flush()
        results[name] = (sorted(set(got)), st.stats.frames, st.stats.su_ok,
                         st.stats.su_bad)
        assert vk.LAUNCHES > 0
        stations[name] = st
    assert ("X", "BATCH XX") in results["sharded"][0]
    assert results["sharded"] == results["unsharded"]
    full, shard = stations["unsharded"], stations["sharded"]
    assert all(t.device.type == cuda.type for s in shard._shards
               for t in convert.tree_leaves(s))
    arr = full.quantize(wb[: full.block_len])
    one = torch.tensor(np.float32(1.0), device=cuda)
    iq = torch.from_numpy(arr).to(cuda)
    _, a = full._step(full._state, iq, one)
    _, b = shard._step_shards(shard._shards, iq, one)
    check_packed(full, b.cpu().numpy(), a.cpu().numpy())


def test_sharded_classic_station_on_card_matches_unsharded(cuda):
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.station import Station
    from torch_station_bank import make_wideband

    cfg = load_ini(_even_bank_ini(), is_text=True)
    B = cfg.buflen_complex
    w = np.concatenate([make_wideband(), np.zeros(4 * B, np.complex64)])
    results = {}
    for mesh in (None, _card_mesh()):
        got = []
        st = Station(cfg, device=cuda, mesh=mesh,
                     on_acars=lambda v, it: got.append((v, it.message)))
        for i in range(0, len(w) - B + 1, B):
            st.process(w[i:i + B])
        results[mesh is None] = (sorted(set(got)), st.stats.frames,
                                 st.stats.su_ok, st.stats.su_bad)
    assert all(len(b._shards) == 2 for b in st.banks.values())
    assert ("X", "BATCH XX") in results[False][0]
    assert results[False] == results[True]


def test_bench_viterbi_and_demod_sections_on_card(cuda):
    from aero_tpu_torch import bench

    rounds = bench.Rounds(2)
    before = vk.LAUNCHES
    vit = bench.bench_viterbi(rounds, B=8, T=2496, n_iter=2, device=cuda)
    demod = bench.bench_demod_only(rounds, B=4, n_iter=2, device=cuda)
    rounds.run()
    assert vk.LAUNCHES == before + 1 + 2 * 2
    for m in (vit, demod):
        assert np.isfinite(m["best"]) and m["best"] > 0
    state, soft, step = bench.viterbi(8, 2496, cuda)
    _, got = step(state, soft)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), viterbi_decode_soft(soft.cpu()))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  bench.viterbi_bits(8, 2496))


def _drained(st, blocks):
    """Each block's packed row as ``st`` drains it over ``blocks``."""
    got, drain = [], st._drain

    def recording(packed):
        got.extend(packed.cpu().numpy())
        drain(packed)
    st._drain = recording
    for q in blocks:
        st.process(q)
    st.flush()
    return got


def test_graphed_fused_station_equals_eager(cuda):
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.device import disable_graphs
    from aero_tpu_torch.runtime.fused_station import FusedStation
    from torch_station_bank import INI, make_wideband

    wb = make_wideband()

    def run():
        st = FusedStation(load_ini(INI, is_text=True), ingest_dtype="int4",
                          batch_host_framing=True, blocks_per_step=4,
                          pipeline_depth=2, device=cuda)
        L = st.block_len
        w = np.concatenate([wb, np.zeros(2 * L, np.complex64)])
        return _drained(st, [w[i:i + L] for i in
                             range(0, (len(w) // L) * L, L)]), st
    with disable_graphs():
        eager, est = run()
    graphed, gst = run()
    assert est.captures == 0 and gst.captures == 1
    assert len(graphed) == len(eager) == 8
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g, e)


def test_graphed_vfo_bank_equals_eager_across_a_retune(cuda):
    from aero_tpu_torch.device import disable_graphs
    from aero_tpu_torch.models.msk import msk_modulate
    from aero_tpu_torch.parallel.vfo_bank import MskVfoBank

    rng = np.random.default_rng(4)
    sig = msk_modulate(rng.integers(0, 2, 4000), 24000, 1200, freq=1000.0)
    x = [np.stack([np.roll(sig, 97 * r)[:16000] for r in range(4)])
         + 0.05 * rng.standard_normal((4, 16000)).astype(np.float32)
         for _ in range(3)]

    def run():
        bank = MskVfoBank(4, 24000, 1200, device=cuda)
        outs = [bank.process_block(x[0])]
        bank.retune([1, 3], [1500.0, 800.0])
        outs += [bank.process_block(b) for b in x[1:]]
        return [{k: v.cpu().numpy() for k, v in o.items()} for o in outs], \
            bank
    with disable_graphs():
        eager, eb = run()
    graphed, gb = run()
    assert eb.captures == 0 and gb.captures == 1
    for g, e in zip(graphed, eager):
        for k in e:
            np.testing.assert_array_equal(g[k], e[k], err_msg=k)


_SYNC_IN_CAPTURE = """
import torch
from aero_tpu_torch.utils.graphs import CaptureError, GraphedStep

def step(state, x):
    new = {"acc": state["acc"] + x}
    if new["acc"].sum().item() > 1e9:      # a host sync
        new["acc"] = new["acc"] * 0
    return new, new["acc"] * 2

st = GraphedStep(step, {"acc": torch.zeros(8, device="cuda")},
                 "the syncing step")
try:
    st(torch.ones(8))
except CaptureError as e:
    print("RAISED", e)
else:
    print("RAN", st.captures)
"""


def test_capture_with_a_host_sync_raises(cuda):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _SYNC_IN_CAPTURE],
                         capture_output=True, text=True, timeout=300,
                         cwd=root, env=env)
    assert "RAISED" in res.stdout, (res.stdout, res.stderr[-2000:])
    assert "the syncing step" in res.stdout


def _eager_then_graphed(run):
    """``run()`` inside ``device.disable_graphs()``, then graphed."""
    from aero_tpu_torch.device import disable_graphs
    with disable_graphs():
        eager = run()
    return eager, run()


def _same_outputs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                          err_msg=k)


def test_graphed_batch_decode_equals_eager_and_counts_launches(cuda):
    """The framer bank's batched decode as a CUDA graph per padded N: the
    eager run's bits and CRC flags byte for byte (and the CPU twin's),
    the Viterbi kernel launched from inside the graph and counted at
    each replay, as many launches as the eager run, one capture per N."""
    from aero_tpu_torch.protocol.batch_framing import BatchPChannelFramerBank
    from aero_tpu_torch.protocol.framing import FRAME_SPECS
    n_soft = FRAME_SPECS[1200].payload_soft_bits
    rng = np.random.default_rng(6)
    batches = [(rng.integers(0, 256, (n, n_soft)).astype(np.float32),
                rng.integers(0, 256, (n, 62)).astype(np.float32))
               for n in (4, 8, 4, 8, 1)]
    kw = dict(rate=1200, use_pallas=False, pre_deinterleaved=True)

    def run(device=cuda):
        bank = BatchPChannelFramerBank(1200, [], device=device)
        vk.reset_launches()
        outs = [{k: v.cpu().numpy() for k, v in bank._decode(
            bank._tensor(p), bank._tensor(q), **kw).items()}
            for p, q in batches]
        return outs, vk.LAUNCHES, bank._decode
    (eager, e_launches, e_step), (graphed, g_launches, g_step) = \
        _eager_then_graphed(run)
    _same_outputs(graphed, eager)
    _same_outputs(graphed, run("cpu")[0])
    assert e_launches == g_launches == len(batches)
    assert e_step.captures == 0
    assert g_step.captures == g_step.keys == 3 and g_step.replays == 5


def test_c_bank_on_card_equals_the_host_framers(cuda):
    """The C bank on the card (``protocol/batch_c_framing.py``: one
    graphed decode per flush, the Viterbi kernel inside) against the
    sequential host framers on the same noisy streams of 8 VFOs (an
    inverted arm, a call-progress hex that changes, a dropout, drains of
    one and of two frames a VFO): equal events, voice calls and trellis
    history after every drain; one capture per padded N, one kernel
    launch per flush that had frames."""
    from aero_tpu_torch.protocol.batch_c_framing import (
        BatchCChannelFramerBank)
    from aero_tpu_torch.protocol.c_framing import CChannelFramer
    from torch_c_streams import FRAME, c_stream, feed_round
    hexes = (b"\x12\x34\x56", b"\xab\xcd\xef")
    kws = [{}, {"invert_arm": 1}, {"hexes": hexes}, {"sigma": 0.6},
           {"dropout": (3 * FRAME + 700, 5000)}, {"invert_arm": 0}, {},
           {"hexes": hexes}]
    streams = {f"C{i:02d}": c_stream(70 + i, 8, **kw)
               for i, kw in enumerate(kws)}
    calls = {"seq": [], "card": []}
    seq = {t: CChannelFramer(on_voice=lambda d, h, t=t: calls["seq"].append(
        (t, d, h))) for t in streams}
    bank = BatchCChannelFramerBank(
        list(streams), device=cuda,
        on_voice={t: (lambda d, h, t=t: calls["card"].append((t, d, h)))
                  for t in streams})
    vk.reset_launches()
    pads, pos, r = set(), 0, 0
    n = max(len(v) for v in streams.values())
    while pos < n:
        block = 9000 if r % 5 == 4 else 2800
        want = feed_round(seq, streams, pos, block)
        got = feed_round(bank.framers, streams, pos, block)
        assert got == want, f"drain {r}"
        assert calls["card"] == calls["seq"], f"drain {r}"
        for t in streams:
            np.testing.assert_array_equal(bank.framers[t].viterbi._carry,
                                          seq[t].viterbi._carry)
        if want:
            pads.add(1 << (len(want) - 1).bit_length())
        pos, r = pos + block, r + 1
    torch.cuda.synchronize()
    assert len(calls["seq"]) >= 50 and len(pads) >= 2
    assert bank._decode.captures == bank._decode.keys == len(pads)
    assert vk.LAUNCHES == bank._decode.replays


def _r_bursts(fs, fb, seed):
    """Two R bursts in noise (10 dB), 80,000 samples."""
    from aero_tpu_torch.models.msk import msk_modulate
    from aero_tpu_torch.protocol.rt_framing import build_r_burst
    info = (bytes([0x1B, 0x28, 0x0A, 0x0B, 0x0C, 0x77]) + b"GRAPHED BST"
            ).ljust(17, b"\0")[:17]
    burst = msk_modulate(build_r_burst(info, preamble_bits=96), fs, fb,
                         freq=fs / 4.0 + 70.0, amplitude=0.3)
    x = np.zeros(80000, np.float32)
    x[9000:9000 + len(burst)] += burst
    x[47000:47000 + len(burst)] += burst
    rng = np.random.default_rng(seed)
    return x + rng.normal(0, np.sqrt(np.mean(burst ** 2) / 10),
                          len(x)).astype(np.float32)


def test_graphed_burst_demod_equals_eager_across_set_center(cuda):
    """A burst MSK demodulator's detection statistics and window function
    as CUDA graphs: the eager run's windows byte for byte across a
    ``set_center`` between the two bursts (the center is an input of the
    window graph: no capture after the retune), each key captured once."""
    from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
    fs, fb = 12000.0, 600.0
    x = _r_bursts(fs, fb, seed=2)

    def run():
        dm = BurstMskDemodulator(fs, fb, device=cuda)
        outs, windows = [], 0
        for i in range(0, len(x), 16000):
            if i == 32000:
                windows = dm._window_fn.captures
                dm.set_center(fs / 4.0 + 90.0)
            outs += dm.process(x[i:i + 16000])
        return outs, dm, windows
    (eager, edm, _), (graphed, gdm, before) = _eager_then_graphed(run)
    _same_outputs(graphed, eager)
    assert sum(o["burst"] for o in graphed) == 2
    assert all(s.captures == 0 for s in edm.steps)
    assert all(s.captures == s.keys > 0 for s in gdm.steps)
    assert before == gdm._window_fn.captures == 1


def test_burst_detection_on_card_is_the_host_loop(cuda):
    """The burst watcher's detection on the card (graphed, its ring on the
    device, the host loop only for a block with a candidate) against the
    host-loop oracle of tests/torch_burst_oracle.py on the same card, over
    300 blocks of noise and a sequence of four R bursts: the same outputs,
    ring and noise floor (its bits) after every block.  The detection
    steps capture one graph per ring bucket while the ring fills (16384
    to 65536 samples, four blocks) and none after: the steady state
    replays one key each."""
    from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
    from torch_burst_oracle import HostLoop
    fs, fb = 24000.0, 1200.0
    rng = np.random.default_rng(12)
    noise = rng.normal(0, 0.05, 300 * 16000).astype(np.float32)
    bursts = np.concatenate([_r_bursts(fs, fb, seed=4),
                             _r_bursts(fs, fb, seed=5)])
    for x in (noise, bursts):
        dm = BurstMskDemodulator(fs, fb, device=cuda)
        oracle = HostLoop(BurstMskDemodulator(fs, fb, device=cuda))
        captures, windows = [], 0
        for i in range(0, len(x), 16000):
            got = dm.process(x[i:i + 16000])
            _same_outputs(got, oracle.process(x[i:i + 16000]))
            assert np.array_equal(dm._ring, oracle._ring)
            assert dm._noise_floor == oracle._noise_floor
            captures.append([s.captures for s in dm.steps[:2]])
            windows += sum(o["burst"] for o in got)
        if x is noise:
            assert windows == 0
            assert captures[3] == captures[-1] == [4, 4]
            assert [s.keys for s in dm.steps[:2]] == [4, 4]
            assert [s.replays for s in dm.steps[:2]] == [300, 300]
        else:
            assert windows == 4


@pytest.mark.parametrize("kind", ["msk", "oqpsk"])
def test_graphed_window_step_equals_eager(cuda, kind):
    """The window function alone, MSK and OQPSK, at two centers through
    one graph: the eager bytes."""
    from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
    from aero_tpu_torch.models.burst_oqpsk import BurstOqpskDemodulator
    fs, fb, cls = ((12000.0, 600.0, BurstMskDemodulator) if kind == "msk"
                   else (48000.0, 10500.0, BurstOqpskDemodulator))
    rng = np.random.default_rng(3)

    def run():
        dm = cls(fs, fb, device=cuda)
        W = dm.cfg.window_len
        win = rng.standard_normal(W).astype(np.float32)
        gate = np.zeros(W, np.float32)
        gate[W // 5: 4 * W // 5] = 1.0
        outs = []
        for c in (dm.freq_center, dm.freq_center + 55.0):
            dm.set_center(c)
            out = dm._window_fn(dm._put(win), dm._put(gate), dm.cfg,
                                dm._put(np.float32(dm.freq_center)))
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return outs, dm._window_fn
    state = rng.bit_generator.state

    def again():
        rng.bit_generator.state = state      # the same window each run
        return run()
    (eager, e_step), (graphed, g_step) = _eager_then_graphed(again)
    assert e_step.captures == 0 and g_step.captures == g_step.keys == 1
    _same_outputs(graphed, eager)
    assert not np.array_equal(graphed[0]["soft"], graphed[1]["soft"])


@pytest.mark.parametrize("kind", ["msk", "oqpsk"])
def test_graphed_single_vfo_demod_equals_eager_across_a_retune(cuda, kind):
    """``MskDemodulator`` / ``OqpskDemodulator``, one graph replay per
    block: the eager run's outputs byte for byte across a
    ``Decoder._set_center`` retune (written into the static buffers: no
    capture after it), one capture."""
    from types import SimpleNamespace
    from aero_tpu_torch.models.msk import MskDemodulator, msk_modulate
    from aero_tpu_torch.models.oqpsk import OqpskDemodulator, oqpsk_modulate
    from aero_tpu_torch.runtime.decoder import Decoder
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, 16000)      # four blocks of either
    if kind == "msk":
        fs, fb, cls, retune = 24000.0, 1200.0, MskDemodulator, 1200.0
        sig = msk_modulate(bits, fs, fb, freq=1000.0)
    else:
        fs, fb, cls, retune = 48000.0, 10500.0, OqpskDemodulator, 8100.0
        sig = oqpsk_modulate(bits, fs, fb, freq=8000.0)
    sig = sig + 0.03 * rng.standard_normal(len(sig)).astype(np.float32)

    def run():
        dm = cls(fs, fb, device=cuda)
        L = dm.cfg.block_len
        outs = dm.process(sig[:2 * L])
        Decoder._set_center(SimpleNamespace(demod=dm), retune)
        outs += dm.process(sig[2 * L:4 * L])
        return outs, dm._step
    (eager, e_step), (graphed, g_step) = _eager_then_graphed(run)
    _same_outputs(graphed, eager)
    assert e_step.captures == 0
    assert len(graphed) == g_step.replays == 4
    assert g_step.captures == g_step.keys == 1


def test_graphed_pfb_channelizer_equals_eager(cuda):
    """The filterbank backend, a graph replay per rate group and block:
    the eager run's int16 payloads byte for byte, one capture per group."""
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.channelizer.pfb import PfbChannelizer
    vfos = "".join(
        f"{i + 1}\\frequency={1545002000 + i * 19000}\n"
        f"{i + 1}\\data_rate={600 if i % 2 else 1200}\n"
        f"{i + 1}\\topic=V{i}\n" for i in range(6))
    cfg = load_ini("[General]\nsample_rate=1536000\n"
                   "center_frequency=1545000000\n[vfos]\nsize=6\n" + vfos,
                   is_text=True)
    rng = np.random.default_rng(5)
    blocks = [(0.1 * (rng.standard_normal(64 * 500)
                      + 1j * rng.standard_normal(64 * 500))
               ).astype(np.complex64) for _ in range(3)]

    def run():
        ch = PfbChannelizer(cfg, device=cuda)
        return [ch.process(b) for b in blocks], ch
    (eager, ech), (graphed, gch) = _eager_then_graphed(run)
    assert graphed == eager
    assert ech.captures == 0 and gch.captures == len(gch._steps) == 2
