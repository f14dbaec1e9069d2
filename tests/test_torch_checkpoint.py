"""Port parity for checkpoints: ``aero_tpu_torch.runtime.checkpoint``.

The format is JAX's leaf for leaf, so a checkpoint written mid-stream by
JAX's ``FusedStation`` or classic ``Station`` resumes in the port's
station of the same configuration: JAX's messages before the split plus
the port's after it equal JAX's uninterrupted run, exactly (the same
ACARS texts in the same order, and the same frame and SU counts).  A
port -> port resume equals the port's uninterrupted run.  A port-written
file has JAX's key set and, apart from the pickled reassembly blobs, JAX's
entry shapes and dtypes.  Wrong configurations, a fused file loaded into
a classic station and a blob naming a foreign class are refused; the CLI
survives a corrupt file; the exact path and the residual are kept.  The
signal is tests/test_checkpoint.py's two-message MSK 1200 stream.
"""

import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from aero_tpu.channelizer import load_ini
from aero_tpu.runtime.fused_station import FusedStation as JaxFused
from aero_tpu.runtime.station import Station as JaxStation
from aero_tpu_torch.runtime import checkpoint as tck
from aero_tpu_torch.runtime import station_main as torch_main
from aero_tpu_torch.runtime.fused_station import FusedStation
from aero_tpu_torch.runtime.station import Station
from tests.test_checkpoint import INI, _wideband

torch.set_num_threads(2)

KINDS = {"fused": (JaxFused, FusedStation), "classic": (JaxStation, Station)}


def _blocks(kind, cfg, wide):
    L = (JaxFused(cfg).block_len if kind == "fused"
         else cfg.buflen_complex)
    w = np.concatenate([wide, np.zeros((2 if kind == "fused" else 4) * L,
                                       np.complex64)])
    n = (len(w) // L) * L
    return [w[i:i + L] for i in range(0, n, L)]


def _make(kind, jax_side, msgs):
    cls = KINDS[kind][0 if jax_side else 1]
    kw = {} if jax_side else {"device": "cpu"}
    return cls(load_ini(INI, is_text=True),
               on_acars=lambda v, it: msgs.append((v, it.message)), **kw)


def _run(st, blocks, msgs=None):
    """Feed every block; with ``msgs``, return the split point of the
    resume tests: the number of blocks after which the first message is
    out and the second is not.  The fused station drains each block
    ``pipeline_depth`` calls later, and a save flushes the blocks in
    flight, so its split is that many blocks earlier."""
    first = None
    for i, b in enumerate(blocks):
        st.process(b)
        if msgs and first is None:
            first = i
    if hasattr(st, "flush"):
        st.flush()
    if first is not None:
        return first + 1 - getattr(st, "pipeline_depth", 0)
    return None


@pytest.fixture(scope="module")
def signal():
    cfg = load_ini(INI, is_text=True)
    wide = _wideband()
    return {k: _blocks(k, cfg, wide) for k in KINDS}


@pytest.mark.parametrize("kind", ["fused", "classic"])
def test_jax_checkpoint_resumes_in_port(signal, tmp_path, kind):
    blocks = signal[kind]
    ref = []
    st_ref = _make(kind, True, ref)
    split = _run(st_ref, blocks, ref)
    assert ref == [("V1", "BEFORE RESTART"), ("V1", "AFTER RESTART")]
    # the split falls between the two messages: the deframer is locked and
    # the second message's frames are in flight
    msgs_a, msgs_b = [], []
    st_a = _make(kind, True, msgs_a)
    for b in blocks[:split]:
        st_a.process(b)
    ckpt = str(tmp_path / f"{kind}.ckpt")
    st_a.save_checkpoint(ckpt)
    assert msgs_a == [("V1", "BEFORE RESTART")]

    st_b = _make(kind, False, msgs_b)
    st_b.load_checkpoint(ckpt)
    assert st_b.stats.su_ok == st_a.stats.su_ok
    _run(st_b, blocks[split:])
    assert msgs_a + msgs_b == ref
    assert (st_b.stats.su_ok, st_b.stats.frames) == (st_ref.stats.su_ok,
                                                     st_ref.stats.frames)


@pytest.mark.parametrize("kind", ["fused", "classic"])
def test_port_checkpoint_resume_is_identical(signal, tmp_path, kind):
    blocks = signal[kind]
    ref = []
    st_ref = _make(kind, False, ref)
    split = _run(st_ref, blocks, ref)
    msgs_a, msgs_b = [], []
    st_a = _make(kind, False, msgs_a)
    for b in blocks[:split]:
        st_a.process(b)
    ckpt = str(tmp_path / f"{kind}.ckpt")
    st_a.save_checkpoint(ckpt)
    st_b = _make(kind, False, msgs_b)
    st_b.load_checkpoint(ckpt)
    if kind == "classic":
        assert st_b.hunters["V1"].freq_center == st_a.hunters["V1"].freq_center
    _run(st_b, blocks[split:])
    assert msgs_a + msgs_b == ref
    assert msgs_b == [("V1", "AFTER RESTART")]
    assert (st_b.stats.su_ok, st_b.stats.frames) == (st_ref.stats.su_ok,
                                                     st_ref.stats.frames)


@pytest.mark.parametrize("kind", ["fused", "classic"])
def test_port_checkpoint_has_jax_layout(signal, tmp_path, kind):
    """The same blocks through both packages, then a save: the same keys,
    and every entry but the reassembly blobs of the same shape and
    dtype."""
    files = {}
    for jax_side in (True, False):
        st = _make(kind, jax_side, [])
        for b in signal[kind][:3]:
            st.process(b)
        path = str(tmp_path / f"{jax_side}.ckpt")
        st.save_checkpoint(path)
        with np.load(path, allow_pickle=False) as z:
            files[jax_side] = {k: (z[k].shape, z[k].dtype) for k in z.files}
    want, got = files[True], files[False]
    assert set(got) == set(want)
    assert any(k.startswith("dev_") for k in got)
    for k in want:
        if not k.startswith("reasm"):
            assert got[k] == want[k], k


def test_burst_watcher_checkpoint_mid_burst(tmp_path):
    """A burst watcher saved while a T burst's window is held over a block
    (its gate run reaches the ring's end), through a file into a fresh
    watcher: the ring and the noise floor come back exactly, and the
    resumed watcher emits the uninterrupted watcher's outputs."""
    from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
    from aero_tpu_torch.models.msk import msk_modulate
    from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu_torch.protocol.rt_framing import build_t_burst
    fs, fb, split = 24000.0, 1200.0, 2
    sus = segment_isu(make_acars_userdata("2", "N100TP", "!", "H1", "A",
                                          "HELD OVER A SAVE"), 0x123456, 0x41)
    burst = msk_modulate(build_t_burst(0x123456, 0x41, sus,
                                       preamble_bits=96),
                         fs, fb, freq=fs / 4.0 + 30.0, amplitude=0.3)
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.3 / np.sqrt(20), 6 * 16000).astype(np.float32)
    start = split * 16000 - 6000
    x[start:start + len(burst)] += burst
    blocks = [x[i:i + 16000] for i in range(0, len(x), 16000)]

    def feed(dm, blocks):
        return [o for b in blocks for o in dm.process(b)]
    ref = feed(BurstMskDemodulator(fs, fb, device="cpu"), blocks)
    a = BurstMskDemodulator(fs, fb, device="cpu")
    assert not any(o["burst"] for o in feed(a, blocks[:split]))
    assert np.mean(a._ring[-4000:] ** 2) > 3 * np.mean(a._ring[:16000] ** 2)
    path = str(tmp_path / "burst.npz")
    np.savez(path, **tck._burst_demod_state(a))
    b = BurstMskDemodulator(fs, fb, device="cpu")
    with np.load(path) as z:
        tck._restore_burst_demod(b, {k: z[k] for k in z.files})
    assert np.array_equal(b._ring, a._ring) and b._ring.dtype == np.float32
    assert b._noise_floor == a._noise_floor
    resumed = feed(b, blocks[split:])
    assert [o["burst"] for o in resumed] == [o["burst"] for o in ref[split:]]
    assert sum(o["burst"] for o in resumed) == 1
    for got, want in zip(resumed, ref[split:]):
        assert np.array_equal(got["soft_bits"], want["soft_bits"])
        assert (got["freq"], got["tone_quality"]) == (want["freq"],
                                                      want["tone_quality"])


def test_checkpoint_rejects_wrong_config(tmp_path):
    st = FusedStation(load_ini(INI, is_text=True), device="cpu")
    ckpt = str(tmp_path / "c.npz")
    st.save_checkpoint(ckpt)
    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i*19000}\n{i+1}\\data_rate=1200\n"
        f"{i+1}\\topic=W{i}\n{i+1}\\gain=100\n" for i in range(2))
    other = load_ini("[General]\nsample_rate=1536000\n"
                     "center_frequency=1545000000\n"
                     f"[vfos]\nsize=2\n{vfos}", is_text=True)
    with pytest.raises(ValueError):
        FusedStation(other, device="cpu").load_checkpoint(ckpt)
    with pytest.raises(ValueError):
        FusedStation(load_ini(INI, is_text=True), gain=5.0,
                     device="cpu").load_checkpoint(ckpt)
    with pytest.raises(ValueError):
        Station(other, device="cpu").load_checkpoint(ckpt)
    # a fused checkpoint will not load into a classic station
    with pytest.raises(ValueError, match="classic"):
        Station(load_ini(INI, is_text=True), device="cpu").load_checkpoint(
            ckpt)


def test_checkpoint_refuses_a_foreign_class(tmp_path):
    """A reassembly blob that names any class but the ISU reassembly types
    (of either package) fails to load instead of running code."""
    cfg = load_ini(INI, is_text=True)
    st = Station(cfg, device="cpu")
    ckpt = str(tmp_path / "c.npz")
    st.save_checkpoint(ckpt)
    with np.load(ckpt, allow_pickle=False) as z:
        entries = {k: z[k] for k in z.files}
    entries["reasm0"] = np.frombuffer(pickle.dumps((io.BytesIO(b""), None)),
                                      np.uint8)
    bad = str(tmp_path / "bad.npz")
    tck._atomic_savez(bad, entries)
    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        Station(cfg, device="cpu").load_checkpoint(bad)
    # the JAX package's module names are mapped onto the port's copies
    from aero_tpu.protocol.isu import ACARSItem as JaxItem
    from aero_tpu_torch.protocol.isu import ACARSItem
    got = tck._restricted_loads(pickle.dumps(JaxItem.__new__(JaxItem)))
    assert type(got) is ACARSItem


def test_checkpoint_exact_path_atomic_and_residual(tmp_path):
    st = FusedStation(load_ini(INI, is_text=True), device="cpu")
    bare = str(tmp_path / "station.ckpt")
    resid = (np.arange(7, dtype=np.float32)
             + 1j * np.arange(7, dtype=np.float32)).astype(np.complex64)
    st.save_checkpoint(bare, residual=resid)
    assert os.path.exists(bare)
    assert not os.path.exists(bare + ".npz")
    assert not os.path.exists(bare + ".tmp")
    np.testing.assert_array_equal(tck.load_residual(bare), resid)
    st.save_checkpoint(bare)
    assert len(tck.load_residual(bare)) == 0
    FusedStation(load_ini(INI, is_text=True), device="cpu").load_checkpoint(
        bare)


@pytest.mark.parametrize("backend", ["fused", "tree"])
def test_station_cli_survives_corrupt_checkpoint(tmp_path, capsys, backend):
    """A truncated checkpoint warns and starts fresh; the shutdown save
    then replaces it with a good one, and a second run resumes from it."""
    ini = tmp_path / "st.ini"
    ini.write_text("sample_rate=288000\ncenter_frequency=1545100000\n"
                   "[vfos]\nsize=1\n1\\frequency=1545100000\n"
                   "1\\data_rate=1200\n1\\topic=VFO1\n")
    ckpt = tmp_path / "bad.ckpt"
    ckpt.write_bytes(b"PK\x03\x04 this is not a checkpoint")
    block = 192000 if backend == "fused" else 57600
    iq = tmp_path / "z.cf32"
    np.zeros(2 * block + 100, np.complex64).tofile(iq)
    argv = ["-c", str(ini), "--iq-file", str(iq), "--device", "cpu",
            "--backend", backend, "--checkpoint", str(ckpt),
            "--stats-every", "1e9"]
    assert torch_main.main(argv) == 0
    err = capsys.readouterr().err
    assert "checkpoint_load_failed" in err and "final_stats" in err
    with np.load(str(ckpt), allow_pickle=False) as z:
        assert "meta_version" in z.files
        assert len(z["meta_residual"]) == 100
    assert torch_main.main(argv) == 0
    err = capsys.readouterr().err
    resumed = [json.loads(line) for line in err.splitlines()
               if "resumed_from" in line]
    assert resumed and resumed[0]["residual_samples"] == 100
