"""The fixtures of tests/torch_natives.py.  In a worker that lost the
reference's native build race, ``reference_natives`` gives the reference
its two libraries back, built from its own sources outside its package,
so that the parity tests hold like against like: the native quantizers
give the port's bytes and the tree channelizer's parity stream holds at
its tolerances.  Nothing is written under ``aero_tpu/``.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest

from tests import torch_natives
from tests.test_torch_channelizer import STREAMS, channelizer_parity
from tests.torch_natives import reference_natives  # noqa: F401


def _lose_the_build(monkeypatch):
    """Set the reference's cache entries as a worker that lost the race
    has them."""
    from aero_tpu import native as jn
    for key in torch_natives.LIBRARIES:
        monkeypatch.setitem(jn._libs, key, None)
    assert not jn.have_native() and not jn.have_native_ingest()
    return jn


def _listing(top):
    """(path, size, mtime) of every file under ``top``, the interpreter's
    bytecode caches aside."""
    out = []
    for d, dirs, files in os.walk(top):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for f in sorted(files):
            st = os.stat(os.path.join(d, f))
            out.append((os.path.relpath(os.path.join(d, f), top),
                        st.st_size, st.st_mtime_ns))
    return out


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="needs g++ to build the native libraries")
def test_reference_natives_restored_after_a_lost_build(monkeypatch, request):
    from aero_tpu_torch import native as tn
    jn = _lose_the_build(monkeypatch)
    assert request.getfixturevalue("reference_natives") is jn
    assert jn.have_native() and jn.have_native_ingest()
    for key in torch_natives.LIBRARIES:
        assert isinstance(jn._libs[key], ctypes.CDLL)
        assert os.path.dirname(jn._libs[key]._name) == torch_natives.BUILD_DIR
    assert tn.have_native_ingest()
    rng = np.random.default_rng(11)
    iq = (0.3 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
          ).astype(np.complex64)
    for dtype in ("int4", "int2", "int8", "int16"):
        want = jn.quantize_native(iq, dtype)
        got = tn.quantize_native(iq, dtype)
        if dtype == "int2":
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    channelizer_parity(*STREAMS["tree_1536k"])


def test_reference_natives_write_nothing_under_the_reference(
        tmp_path, monkeypatch, request):
    assert torch_natives.BUILD_DIR == os.path.join(
        torch_natives.ROOT, "build", "aero_tpu_ref")
    ref = os.path.join(torch_natives.ROOT, "aero_tpu")
    before = _listing(ref)
    jn = _lose_the_build(monkeypatch)
    # an empty build directory, so that both libraries are compiled here
    build_dir = str(tmp_path / "aero_tpu_ref")
    monkeypatch.setattr(torch_natives, "BUILD_DIR", build_dir)
    request.getfixturevalue("reference_natives")
    if shutil.which("g++") is not None:
        assert jn.have_native() and jn.have_native_ingest()
        built = sorted(os.listdir(build_dir))
        assert [f.split("_")[0] for f in built] == ["libaeroingest",
                                                    "libaeroviterbi"]
        assert all(f.endswith(".so") for f in built), built
    else:
        assert not jn.have_native() and not jn.have_native_ingest()
    assert _listing(ref) == before
