"""Native (C++) host-side components of the port.

``ingest.cc`` and ``viterbi.cc`` are byte-for-byte copies of
``aero_tpu/native``'s sources (the drift guard in
tests/test_torch_imports.py holds them equal); this loader has the same
public functions as ``aero_tpu.native``:

- ``libaeroviterbi``: K=7 r=1/2 soft Viterbi, used by ``StreamingViterbi``
  for single-frame host decodes (the continuous framers' path).
- ``libaeroingest``: the SDR reader's per-sample work — DC correction,
  IQ quantization to the int2/int4/int8/int16 wire dtypes, PCM
  conversion.

Each library is built with ``g++`` on first use into
``build/aero_tpu_torch/`` beside the package (never into the package or
``aero_tpu/``); its name carries the hash of its source and flags, so an
edited source builds anew.  Where no compiler is present the loaders
return None: ``have_native()`` is False and the callers keep their
plain numpy / torch paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "aero_tpu_torch")
_libs = {}


def _build_and_load(name: str, src_base: str, extra_flags=()):
    if name in _libs:
        return _libs[name]
    src = os.path.join(_DIR, src_base)
    flags = ["-O3", *extra_flags, "-shared", "-fPIC"]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(["g++", *flags, "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            _libs[name] = None
            return None
    try:
        _libs[name] = ctypes.CDLL(so)
    except OSError:
        _libs[name] = None
    return _libs[name]


def _load():
    lib = _build_and_load("libaeroviterbi", "viterbi.cc")
    if lib is not None and not hasattr(lib, "_sigs_set"):
        lib.aero_viterbi_decode_soft.restype = ctypes.c_int
        lib.aero_viterbi_decode_soft.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib._sigs_set = True
    return lib


def _load_ingest():
    lib = _build_and_load("libaeroingest", "ingest.cc",
                          extra_flags=("-march=native", "-funroll-loops"))
    if lib is not None and not hasattr(lib, "_sigs_set"):
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.aero_dc_correct.argtypes = [f32p, ctypes.c_long, ctypes.c_float,
                                        f32p]
        lib.aero_quantize_int4.argtypes = [f32p, ctypes.c_long,
                                           ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_uint8)]
        lib.aero_quantize_int2.argtypes = [f32p, ctypes.c_long,
                                           ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_uint8)]
        lib.aero_quantize_int8.argtypes = [f32p, ctypes.c_long,
                                           ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_int8)]
        lib.aero_quantize_int16.argtypes = [f32p, ctypes.c_long,
                                            ctypes.c_float,
                                            ctypes.POINTER(ctypes.c_int16)]
        lib.aero_pcm16_to_f32.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                          ctypes.c_long, f32p]
        lib._sigs_set = True
    return lib


def have_native() -> bool:
    return _load() is not None


def have_native_ingest() -> bool:
    return _load_ingest() is not None


def library_paths() -> dict:
    """The files of the libraries loaded so far, by library name."""
    return {name: lib._name for name, lib in _libs.items() if lib is not None}


def _as_f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def dc_correct_native(iq: np.ndarray, alpha: float,
                      state: np.ndarray) -> np.ndarray:
    """In-place one-pole DC correction of complex64 [n]; ``state`` is a
    float32 [2] carry, updated in place.  Returns ``iq``."""
    lib = _load_ingest()
    if lib is None:
        raise RuntimeError("native ingest unavailable")
    assert iq.dtype == np.complex64 and iq.flags.c_contiguous
    assert state.dtype == np.float32 and state.size == 2
    lib.aero_dc_correct(_as_f32p(iq.view(np.float32)), iq.size,
                        ctypes.c_float(alpha), _as_f32p(state))
    return iq


def quantize_native(iq: np.ndarray, dtype: str):
    """complex64 [n] -> packed uint8 [n] ("int4"), (packed uint8 [n/2],
    sigma) ("int2") or planar [2, n] ("int8"/"int16").  Bit-exact with
    the numpy paths in FusedStation.quantize."""
    lib = _load_ingest()
    if lib is None:
        raise RuntimeError("native ingest unavailable")
    iq = np.ascontiguousarray(iq, np.complex64)
    p = _as_f32p(iq.view(np.float32))
    n = iq.size
    if dtype == "int4":
        out = np.empty(n, np.uint8)
        lib.aero_quantize_int4(p, n, ctypes.c_float(7.0),
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_uint8)))
    elif dtype == "int2":
        assert n % 2 == 0
        arms = iq.view(np.float32)
        sigma = float(np.sqrt(np.mean(arms * arms))) or 1.0
        out = np.empty(n // 2, np.uint8)
        lib.aero_quantize_int2(p, n, ctypes.c_float(sigma),
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_uint8)))
        return out, np.float32(sigma)
    elif dtype == "int8":
        out = np.empty((2, n), np.int8)
        lib.aero_quantize_int8(p, n, ctypes.c_float(127.0),
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_int8)))
    elif dtype == "int16":
        out = np.empty((2, n), np.int16)
        lib.aero_quantize_int16(p, n, ctypes.c_float(32767.0),
                                out.ctypes.data_as(
                                    ctypes.POINTER(ctypes.c_int16)))
    else:
        raise ValueError(dtype)
    return out


def pcm16_to_f32_native(pcm: np.ndarray) -> np.ndarray:
    lib = _load_ingest()
    if lib is None:
        raise RuntimeError("native ingest unavailable")
    pcm = np.ascontiguousarray(pcm, "<i2")
    out = np.empty(pcm.size, np.float32)
    lib.aero_pcm16_to_f32(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                          pcm.size, _as_f32p(out))
    return out


def viterbi_decode_soft_native(soft) -> np.ndarray:
    """soft: array-like of soft bytes (0..255); returns hard bits [T//2]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native viterbi unavailable")
    soft = np.ascontiguousarray(np.clip(np.asarray(soft), 0, 255),
                                dtype=np.uint8)
    out = np.empty(soft.size // 2, np.uint8)
    lib.aero_viterbi_decode_soft(
        soft.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), soft.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
