"""The port's native ingest library (aero_tpu_torch/native/ingest.cc),
the counterpart of tests/test_native_ingest.py: bit-exact against the
port's own numpy forms (``FusedStation.quantize`` without the library,
``dc_correct_python``), the DC-tracker recurrence across chunks, and a
loader that six processes building at once into one empty directory all
load from.

Skipped only where there is no ``g++``; where there is one, a library
that does not load is a failure.
"""

import os
import select
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from aero_tpu_torch import native
from aero_tpu_torch.channelizer import load_ini
from aero_tpu_torch.channelizer.channelizer import dc_correct_python
from aero_tpu_torch.runtime.fused_station import FusedStation

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the native "
                                       "libraries")

_INI = ("sample_rate=1536000\ncenter_frequency=1545000000\n[vfos]\n"
        "size=1\n1\\frequency=1545010000\n1\\data_rate=1200\n"
        "1\\topic=V\n1\\gain=100\n")


@pytest.fixture
def tn():
    assert native.have_native() and native.have_native_ingest()
    return native


def _iq(n=100001, seed=3, scale=0.7):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _numpy_quantize(monkeypatch, iq, dtype):
    """The port's numpy form: ``FusedStation.quantize`` without the
    library."""
    st = FusedStation(load_ini(_INI, is_text=True), ingest_dtype=dtype,
                      device="cpu")
    with monkeypatch.context() as m:
        m.setitem(native._libs, "libaeroingest", None)
        return st.quantize(iq)


def test_quantize_int4_matches_numpy(tn, monkeypatch):
    iq = _iq()
    got = tn.quantize_native(iq, "int4")
    want = _numpy_quantize(monkeypatch, iq, "int4")
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (iq.size,)
    np.testing.assert_array_equal(got, want)


def test_quantize_int2_matches_numpy(tn, monkeypatch):
    iq = _iq(n=100000)
    got, sigma = tn.quantize_native(iq, "int2")
    want, want_sigma = _numpy_quantize(monkeypatch, iq, "int2")
    assert abs(sigma - want_sigma) < 1e-6
    assert got.shape == want.shape == (iq.size // 2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_quantize_planar_matches_numpy(tn, monkeypatch, dtype):
    iq = _iq(seed=4, scale=1.3)   # exercise clipping
    got = tn.quantize_native(iq, dtype)
    want = _numpy_quantize(monkeypatch, iq, dtype)
    assert got.dtype == want.dtype
    assert got.shape == want.shape == (2, iq.size)
    np.testing.assert_array_equal(got, want)


def test_dc_correct_recurrence(tn):
    iq = (_iq(5000, seed=5) + (0.25 - 0.1j)).astype(np.complex64)
    alpha = 2e-3
    # natively in two chunks: the state carries across
    state = np.zeros(2, np.float32)
    a, b = iq[:2000].copy(), iq[2000:].copy()
    tn.dc_correct_native(a, alpha, state)
    tn.dc_correct_native(b, alpha, state)
    got = np.concatenate([a, b])
    # the per-sample recurrence
    dc = 0.0 + 0.0j
    want = np.empty_like(iq)
    for i, x in enumerate(iq):
        dc = dc + alpha * (x - dc)
        want[i] = x - dc
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(np.mean(got[3000:])) < 0.01
    # the port's scipy form over the same two chunks: the same recurrence
    # to the same tolerance, and the same carry
    py_state = np.zeros(2, np.float32)
    py = np.concatenate([dc_correct_python(iq[:2000], alpha, py_state),
                         dc_correct_python(iq[2000:], alpha, py_state)])
    np.testing.assert_allclose(py, want, atol=1e-5)
    np.testing.assert_allclose(py_state, state, atol=1e-5)


def test_pcm16_roundtrip(tn):
    pcm = np.array([-32768, -1, 0, 1, 32767, 12345], "<i2")
    out = tn.pcm16_to_f32_native(pcm)
    np.testing.assert_allclose(out, pcm.astype(np.float32) / 32768.0)


def test_fused_station_uses_native_quantize(tn, monkeypatch):
    st = FusedStation(load_ini(_INI, is_text=True), ingest_dtype="int4",
                      device="cpu")
    iq = _iq(st.block_len, seed=6, scale=0.1)
    calls = []
    quantize = tn.quantize_native

    def counted(*args):
        calls.append(args[1])
        return quantize(*args)
    monkeypatch.setattr(tn, "quantize_native", counted)
    q = st.quantize(iq)
    assert calls == ["int4"]
    assert q.dtype == np.uint8 and q.shape == (st.block_len,)
    np.testing.assert_array_equal(q, quantize(iq, "int4"))


# one process: import the loader, say so, wait for the word, then load both
# libraries from the directory given
_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from aero_tpu_torch import native
native.BUILD_DIR = sys.argv[2]
print("ready", flush=True)
sys.stdin.readline()
loaded = native.have_native() and native.have_native_ingest()
dirs = sorted({os.path.dirname(p) for p in native.library_paths().values()})
print(int(loaded), *dirs, flush=True)
"""


def test_six_processes_build_into_one_directory_and_all_load(tmp_path):
    """The race the reference's loader loses (compiling straight into the
    final file): six fresh interpreters build both libraries at once into
    one empty directory, and every one of them loads both."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, root, build_dir],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True) for _ in range(6)]
    try:
        deadline = time.monotonic() + 120
        for p in procs:
            up, _, _ = select.select([p.stdout], [], [],
                                     max(0.0, deadline - time.monotonic()))
            assert up and p.stdout.readline() == "ready\n"
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 6
    assert outs == [f"1 {build_dir}\n"] * 6, outs
    built = sorted(os.listdir(build_dir))
    assert len(built) == 2 and all(f.endswith(".so") for f in built), built
