#!/usr/bin/env python3
"""Where a block's time goes in the PyTorch port's fused station on a card,
with its device step graphed (the default) and eager.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_profile_step.py [--blocks 12] [--out FILE]

It builds chip_smoke.py's 50-VFO MSK-1200 bank (1.536 MS/s, int4 ingest)
with no pipelining, so each stage of a block can be
timed on its own on the host clock, and feeds it ``--blocks`` blocks of
the smoke's wideband signal four times, in turns: eager (inside
``device.disable_graphs()``), graphed, graphed, eager.  Per pass:

- quantize: ``FusedStation.quantize`` of the complex block (host);
- device step: ``_dispatch`` (upload + one step: a CUDA-graph replay, or
  the step's ops one by one) up to ``torch.cuda.synchronize()``;
- drain: ``_drain``, the packed buffer's copy back, host framing and the
  batched Viterbi decode on the card, split by stage from the port's
  tracer (switched on before the station is built; the spans' self
  times, ``chip_smoke.stage_split``): D2H, the batched decode (a graph
  replay, or its ops eagerly), the burst watchers, the UW search, frame
  preparation, frame bookkeeping, SU dispatch and the drain's own.

It prints the pass's first block and the median of the blocks after the
third for each stage, and the drain's split (median and mean per
drain) with the drain steps' captures.  Then, from
the state the pass left, the step alone on one block
(``chip_smoke.step_times``): the host's enqueue time and the
CUDA-event device time per step over 10 steps, and under
``torch.profiler`` over 3 steps the device operations per step (the
kernels, copies and sets the profiler reports on the device; a replay's
kernels are reported one by one where the profiler sees them), the graph
launches, their summed device time, the device's idle share of the step
and the station's captures.  Each mode's op table goes to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the bank, its wideband signal, step_times)
from aero_tpu_torch.channelizer import load_ini  # noqa: E402
from aero_tpu_torch.device import (disable_graphs,  # noqa: E402
                                   set_fp32_precision)
from aero_tpu_torch.runtime.fused_station import FusedStation  # noqa: E402
from aero_tpu_torch.utils.profiling import TRACER  # noqa: E402


def stages(st, wide, n_blocks: int, card: str, mode: str) -> np.ndarray:
    """One pass of serial blocks; prints each stage's first block and
    median; returns the last quantized block."""
    L = st.block_len
    ms = {"quantize": [], "device step": [], "drain": []}
    TRACER.take()
    for b in range(n_blocks):
        t0 = time.perf_counter()
        arr = st.quantize(wide[b * L:(b + 1) * L])
        t1 = time.perf_counter()
        st._pending.append((arr, np.float32(1.0)))
        st._dispatch()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st._drain(st._inflight.popleft())
        t3 = time.perf_counter()
        for name, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2)):
            ms[name].append(1e3 * dt)
    split = chip_smoke.stage_split(TRACER.take())
    for name, v in ms.items():
        print(f"{mode}: {name}: first block {v[0]:.3f} ms, median of "
              f"blocks 4-{n_blocks} {statistics.median(v[3:]):.3f} ms "
              f"({card})", flush=True)
    warm = {k: v[3:] for k, v in split.items()}
    print(f"{mode}: drain split over blocks 4-{n_blocks}, "
          f"{chip_smoke.split_text(warm)}; drain step captures: "
          f"{chip_smoke._captures_text(chip_smoke.drain_steps(st))} "
          f"({card})", flush=True)
    return arr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_step.txt"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    set_fp32_precision()
    TRACER.on = True
    st = FusedStation(load_ini(chip_smoke.bank_ini(), is_text=True),
                      ingest_dtype="int4", pipeline=False, device="cuda")
    wide = chip_smoke.make_wideband(st.block_len, args.blocks)
    tables = []
    for mode in ("eager", "graphed", "graphed", "eager"):
        with (disable_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            arr = stages(st, wide, args.blocks, card, mode)
            got = chip_smoke.step_times(st, arr, card, "L-band")
        tables.append(f"--- {mode} ---\n{got['table']}")
    print(f"frames {st.stats.frames}, su_ok {st.stats.su_ok}, "
          f"su_bad {st.stats.su_bad}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n" + "\n".join(tables[:2]) + "\n")
    print(f"op tables: {os.path.relpath(args.out, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
