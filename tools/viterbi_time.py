#!/usr/bin/env python3
"""Time the CUDA Viterbi wrapper of a checkout of the port, two ways.

Run on a machine with a CUDA card and nvcc:

    python3 tools/viterbi_time.py [CHECKOUT]

CHECKOUT is the root of a checkout of this repository (default: the one
that holds this file).  Its ``aero_tpu_torch.ops.viterbi_kernel`` is
imported, built and timed, so that two versions can be compared in one
run on one card: run them as A, B, B, A.  At each main-path shape (B=64,
T=631; B=256, T=2551; B=1, T=160, 352 and 1600) the input is the
"integral" soft bytes of ``tests/torch_soft.py``, seed 1, as
``chip_smoke.py`` times them.  They go to the card as uint8 where the
wrapper takes uint8, else as float32 (the kernel before its uint8 input).
Two times per call, both between CUDA events after a warm-up:

- call: the wrapper called 200 times back to back.  This is what a caller
  waits for: the wrapper's host work (checks, allocation, launch) or the
  device's time, whichever is longer.
- device: 20 calls captured in one CUDA graph and replayed 10 times.  This
  is the device's time alone.

Prints one line per shape, with the card's name and power limit, and then
one JSON line ``{"checkout": ..., "card": ..., "times": [{"B", "T",
"dtype", "call_ms", "device_ms"}, ...]}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_SHAPES = ((64, 631), (256, 2551), (1, 160), (1, 352), (1, 1600))


def call_ms(fn, n: int = 200) -> float:
    """Time per call of ``fn`` called ``n`` times back to back."""
    fn()                                   # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in a CUDA
    graph, replayed ``reps`` times, so the host's time per call is not in
    it."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    checkout = os.path.abspath(argv[0] if argv else ROOT)
    if not torch.cuda.is_available():
        raise SystemExit("viterbi_time: needs a CUDA card")
    sys.path[:0] = [checkout, os.path.join(ROOT, "tests")]
    from aero_tpu_torch.ops import viterbi_kernel as vk
    from torch_soft import soft_bytes
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    vk.build()
    times = []
    for B, T in MAIN_SHAPES:
        soft = torch.from_numpy(soft_bytes("integral", B, T, seed=1)).cuda()
        try:
            x = soft.to(torch.uint8)
            vk.viterbi_decode_soft_cuda(x)
        except TypeError:
            x = soft
        t = {"B": B, "T": T, "dtype": str(x.dtype).split(".")[-1],
             "call_ms": call_ms(lambda: vk.viterbi_decode_soft_cuda(x)),
             "device_ms": device_ms(lambda: vk.viterbi_decode_soft_cuda(x))}
        times.append(t)
        print(f"B={B} T={T} {t['dtype']}: call {t['call_ms']:.4f} ms, "
              f"device {t['device_ms']:.4f} ms ({card}; {checkout})",
              flush=True)
    print(json.dumps({"checkout": checkout, "card": card, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
