"""Fixtures that put the reference and the port on the same host ingest
path, whichever xdist worker a parity test lands in.

The reference's loader (``aero_tpu/native/__init__.py:_build_and_load``)
compiles straight into ``aero_tpu/native/`` with no lock and no
temporary file, and caches None for the whole process when the load
then fails.  Workers that build at once can lose that race and keep the
reference's numpy and scipy paths while the port, whose loader is free
of the race, takes its native routines: the two channelizers' DC
trackers then agree only to float32 rounding, which flips int8 bytes.

- ``reference_natives``: where ``g++`` is present and the reference has
  no library loaded in this process, build the reference's own sources
  into ``build/aero_tpu_ref/`` (the reference loader's flags; a
  per-process temporary file and ``os.replace``, the source hash in the
  name) and install the handles in ``aero_tpu.native._libs`` under the
  reference's keys for the test's length.  Where ``g++`` is absent it
  does nothing, and both packages take their numpy paths.
- ``ingest``: a parity test's host ingest path, ``"native"`` (both
  packages' libraries, the reference's installed as above) or ``"numpy"``
  (both packages' ingest libraries set to None, as on a machine without
  ``g++``).

Nothing here writes under ``aero_tpu/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(ROOT, "aero_tpu", "native")
BUILD_DIR = os.path.join(ROOT, "build", "aero_tpu_ref")

# the reference loader's cache keys, sources and g++ flags
LIBRARIES = {
    "libaeroingest.so": ("ingest.cc", ("-O3", "-march=native",
                                       "-funroll-loops", "-shared", "-fPIC")),
    "libaeroviterbi.so": ("viterbi.cc", ("-O3", "-shared", "-fPIC")),
}


def build_reference_library(key: str, build_dir: str) -> str:
    """Compile the reference's source for cache entry ``key`` into
    ``build_dir`` (once per source and flags) and return the file."""
    src_base, flags = LIBRARIES[key]
    src = os.path.join(REF_NATIVE, src_base)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    so = os.path.join(build_dir, f"{key[:-len('.so')]}_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *flags, "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def install_reference_natives(monkeypatch):
    """Load the reference's libraries where ``g++`` is and this process
    has none; returns ``aero_tpu.native``."""
    from aero_tpu import native as jn
    if shutil.which("g++") is not None:
        for key in LIBRARIES:
            # missing too: the reference's own loader would build in the
            # package, racing the other workers
            if jn._libs.get(key) is None:
                so = build_reference_library(key, BUILD_DIR)
                monkeypatch.setitem(jn._libs, key, ctypes.CDLL(so))
    return jn


@pytest.fixture
def reference_natives(monkeypatch):
    """``aero_tpu.native`` with both libraries loaded where ``g++`` is."""
    return install_reference_natives(monkeypatch)


@pytest.fixture(params=["native", "numpy"])
def ingest(request, monkeypatch):
    """The host ingest path both packages take in this test."""
    from aero_tpu import native as jn
    from aero_tpu_torch import native as tn
    if request.param == "native":
        install_reference_natives(monkeypatch)
    else:
        monkeypatch.setitem(jn._libs, "libaeroingest.so", None)
        monkeypatch.setitem(tn._libs, "libaeroingest", None)
    assert jn.have_native_ingest() == tn.have_native_ingest()
    return request.param
