"""The batched soft Viterbi decoder as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``aero_tpu/ops/pallas/viterbi_kernel.py``
(``viterbi_decode_soft_pallas`` / ``viterbi_acs_pallas``).  The source is
``aero_tpu_torch/csrc/viterbi.cu`` (read it for the design and what bounds
it on the card); it has a plain C interface, is compiled by ``nvcc`` for
``sm_90a`` into ``build/aero_tpu_torch/`` on first use (rebuilt when the
source changes: the library name carries the source hash) and is loaded
with ``ctypes``.

``viterbi_decode_soft_cuda(soft [B, 2T] f32) -> bits [B, T] uint8``:

- a CPU tensor goes to the plain-torch twin
  (``protocol/viterbi.py:viterbi_decode_soft``);
- a CUDA tensor launches the kernel, or raises: there is no fallback.

Any T is accepted (no padding to a chunk multiple) and B is the grid (no
slicing into groups of streams).  ``LAUNCHES`` counts kernel launches.
``stream_decoder(device)`` wraps it for one numpy stream, the R/T
framer's checkpoint decodes (B=1, T = rows*32).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "viterbi.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "aero_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = 0          # kernel launches since import (or the last reset)
_lib = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def viterbi_decode_soft_cuda(soft: torch.Tensor) -> torch.Tensor:
    """Batched soft Viterbi: soft [B, 2T] float32 bytes -> bits [B, T]
    uint8.  CPU tensor: plain-torch twin.  CUDA tensor: the kernel."""
    global LAUNCHES
    if not isinstance(soft, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(soft)!r}")
    if soft.device.type == "cpu":
        return viterbi_decode_soft(soft)
    if soft.device.type != "cuda":
        raise ValueError(f"unsupported device {soft.device}")
    if soft.dtype != torch.float32:
        raise TypeError(f"soft must be float32, got {soft.dtype}")
    if soft.dim() != 2 or soft.shape[1] % 2:
        raise ValueError(f"soft must be [B, 2T], got {tuple(soft.shape)}")
    if not soft.is_contiguous():
        raise ValueError("soft must be contiguous")
    B, T = soft.shape[0], soft.shape[1] // 2
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError(f"shape {tuple(soft.shape)} too large")
    fn = _load().aero_viterbi_decode_soft_cuda
    surv = torch.empty((B, T), dtype=torch.int64, device=soft.device)
    bits = torch.empty((B, T), dtype=torch.uint8, device=soft.device)
    if B == 0 or T == 0:
        return bits
    with torch.cuda.device(soft.device):
        stream = torch.cuda.current_stream(soft.device).cuda_stream
        err = fn(soft.data_ptr(), B, T, surv.data_ptr(), bits.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return bits


def stream_decoder(device):
    """A decoder of ONE soft stream, for the R/T framer's checkpoint
    decodes: numpy soft bytes [2T] -> numpy bits [T] uint8, through
    ``viterbi_decode_soft_cuda`` on a one-row tensor on ``device`` (the
    kernel on a card, the plain-torch twin on the CPU)."""
    dev = torch.device(device)

    def decode(soft):
        row = torch.from_numpy(np.ascontiguousarray(soft, np.float32))
        return viterbi_decode_soft_cuda(row.reshape(1, -1).to(dev))[0].cpu(
            ).numpy()
    return decode
