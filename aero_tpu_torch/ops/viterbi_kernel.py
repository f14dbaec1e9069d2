"""The batched soft Viterbi decoder as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``aero_tpu/ops/pallas/viterbi_kernel.py``
(``viterbi_decode_soft_pallas`` / ``viterbi_acs_pallas``).  The source is
``aero_tpu_torch/csrc/viterbi.cu`` (read it for the design and what bounds
it on the card); it has a plain C interface, is compiled by ``nvcc`` for
``sm_90a`` into ``build/aero_tpu_torch/`` on first use (rebuilt when the
source changes: the library name carries the source hash) and is loaded
with ``ctypes``.

``viterbi_decode_soft_cuda(soft [B, 2T]) -> bits [B, T] uint8``:

- a CPU tensor (uint8 or float32 soft bytes) goes to the plain-torch twin
  (``protocol/viterbi.py:viterbi_decode_soft``);
- a CUDA tensor must hold uint8 soft bytes (``TypeError`` otherwise) and
  launches the kernel, or raises: there is no fallback.

``viterbi_decode_rows(soft [B, 2T])`` is the framer banks' decode: on a
card the kernel, as above; on the CPU the native host decoder
(``native/viterbi.cc``) row by row where it is built, else the twin.

B is the grid (one block of one warp per stream).  T is not padded to a
chunk multiple; on a card it is bounded by the block's shared memory (the
stream's soft bytes and one 8-byte decision word per step): ``max_t``
asks the kernel's library for the bound, and a longer stream raises
``ValueError``.  On the CPU the twin takes any T.
``LAUNCHES`` counts kernel launches, through the replays of a CUDA graph
that captured the wrapper too (``utils/graphs.py:count_launch``: a replay
runs no host code, so the capture records the launch and each replay
counts it).  ``stream_decoder(device)`` wraps the
wrapper for one numpy stream, the R/T framer's checkpoint decodes (B=1,
T = rows*32); ``soft_to_bytes`` is the host check both host callers make
before a stream goes to the card as bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from aero_tpu_torch import native
from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
from aero_tpu_torch.utils.graphs import count_launch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "viterbi.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "aero_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = 0          # kernel launches since import (or the last reset)
_lib = None
_max_t = {}           # device index -> the largest T the kernel takes


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _count_launch() -> None:
    global LAUNCHES
    LAUNCHES += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA Viterbi kernel is built "
                       "from source on first use (PATH or CUDA_HOME)")


def build(verbose: bool = False) -> str:
    """Compile csrc/viterbi.cu if its current hash has no library yet;
    returns the library path.  Raises on a failed build."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libaero_viterbi_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.aero_viterbi_decode_soft_cuda
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        lib.aero_viterbi_max_t.restype = ctypes.c_int
        lib.aero_viterbi_max_t.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def max_t(device) -> int:
    """The largest T the kernel takes on the CUDA ``device``: one block
    holds the stream's soft bytes and decisions in the card's opt-in
    shared memory (the layout is the kernel's; 23240 on an H100)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _max_t:
        t = _load().aero_viterbi_max_t(idx)
        if t < 0:
            raise RuntimeError(f"shared-memory query failed: cudaError {-t}")
        _max_t[idx] = t
    return _max_t[idx]


def viterbi_decode_soft_cuda(soft: torch.Tensor) -> torch.Tensor:
    """Batched soft Viterbi: soft bytes [B, 2T] -> bits [B, T] uint8.
    CPU tensor (uint8 or float32): plain-torch twin.  CUDA tensor (uint8
    only): the kernel.  The shared-memory bound is queried once per device
    and cached, so a CUDA-graph capture after one eager call (the graphed
    steps' warm-up) asks the device nothing."""
    if not isinstance(soft, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(soft)!r}")
    if soft.device.type == "cpu":
        return viterbi_decode_soft(soft)
    if soft.device.type != "cuda":
        raise ValueError(f"unsupported device {soft.device}")
    if soft.dtype != torch.uint8:
        raise TypeError(f"soft must be uint8 soft bytes on {soft.device}, "
                        f"got {soft.dtype}")
    if soft.dim() != 2 or soft.shape[1] % 2:
        raise ValueError(f"soft must be [B, 2T], got {tuple(soft.shape)}")
    if not soft.is_contiguous():
        raise ValueError("soft must be contiguous")
    B, T = soft.shape[0], soft.shape[1] // 2
    limit = max_t(soft.device)
    if B >= 2 ** 31 or T > limit:
        raise ValueError(f"shape {tuple(soft.shape)} too large: T is at "
                         f"most {limit} (one block's shared memory)")
    bits = torch.empty((B, T), dtype=torch.uint8, device=soft.device)
    if B == 0 or T == 0:
        return bits
    fn = _load().aero_viterbi_decode_soft_cuda
    with torch.cuda.device(soft.device):
        stream = torch.cuda.current_stream(soft.device).cuda_stream
        err = fn(soft.data_ptr(), B, T, bits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: cudaError {err}")
    count_launch(_count_launch)
    return bits


def viterbi_decode_rows(soft: torch.Tensor) -> torch.Tensor:
    """The framer banks' batched decode: soft bytes [B, 2T] -> bits [B, T]
    uint8.  A CUDA tensor: ``viterbi_decode_soft_cuda``, the kernel.  A CPU
    tensor: the native host decoder row by row where it is built (the
    sequential framers' decoder, bit-exact with the twin and far faster on
    the host), else the plain-torch twin."""
    if soft.device.type != "cpu" or not native.have_native():
        return viterbi_decode_soft_cuda(soft)
    bits = np.empty((soft.shape[0], soft.shape[1] // 2), np.uint8)
    for i, row in enumerate(soft.numpy()):
        bits[i] = native.viterbi_decode_soft_native(row)
    return torch.from_numpy(bits)


def soft_to_bytes(soft) -> np.ndarray:
    """Numpy soft values -> uint8, after checking on the host that each is
    a whole number in 0..255 (ValueError otherwise): the kernel's integer
    metrics equal the float decoder's only on whole bytes."""
    soft = np.asarray(soft)
    if soft.size and not (np.all(soft >= 0) and np.all(soft <= 255)
                          and np.all(soft == np.round(soft))):
        raise ValueError("soft values must be whole numbers in 0..255")
    return np.ascontiguousarray(soft, np.uint8)


def stream_decoder(device):
    """A decoder of ONE soft stream, for the R/T framer's checkpoint
    decodes: numpy soft bytes [2T] (whole numbers in 0..255) -> numpy bits
    [T] uint8, through ``viterbi_decode_soft_cuda`` on a one-row uint8
    tensor on ``device`` (the kernel on a card, the plain-torch twin on
    the CPU)."""
    dev = torch.device(device)

    def decode(soft):
        row = torch.from_numpy(soft_to_bytes(soft).reshape(1, -1))
        return viterbi_decode_soft_cuda(row.to(dev))[0].cpu().numpy()
    return decode
