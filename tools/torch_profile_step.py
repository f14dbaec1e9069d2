#!/usr/bin/env python3
"""Where a block's time goes in the PyTorch port's fused station on a card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_profile_step.py [--blocks 12] [--out FILE]

It builds chip_smoke.py's 50-VFO MSK-1200 bank (1.536 MS/s, int4 ingest,
batch framing on) with no pipelining, so each stage of a block can be
timed on its own on the host clock, and feeds it ``--blocks`` blocks of
the smoke's wideband signal:

- quantize: ``FusedStation.quantize`` of the complex block (host);
- device step: ``_dispatch`` (upload + one ``_step``) up to
  ``torch.cuda.synchronize()``;
- drain: ``_drain``, the packed buffer's copy back, host framing and the
  batched Viterbi decode on the card.

It prints the first block's time and the median of the blocks after the
third for each stage.  Then, from the state the run left, it times
``_step`` alone on one block: the host's enqueue time and the CUDA-event
device time per step over 10 steps, and under ``torch.profiler`` over 5
steps, the device operations per step (kernels, copies and sets), their
summed device time and the device's idle share of the step.  The
profiler's op table goes to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the bank and its wideband signal)
from aero_tpu_torch.channelizer import load_ini  # noqa: E402
from aero_tpu_torch.device import set_fp32_precision  # noqa: E402
from aero_tpu_torch.runtime.fused_station import FusedStation  # noqa: E402


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
    st = FusedStation(load_ini(chip_smoke.bank_ini(), is_text=True),
                      ingest_dtype="int4", batch_host_framing=True,
                      pipeline=False, device="cuda")
    L = st.block_len
    wide = chip_smoke.make_wideband(L, args.blocks)

    stages = {"quantize": [], "device step": [], "drain": []}
    for b in range(args.blocks):
        t0 = time.perf_counter()
        arr = st.quantize(wide[b * L:(b + 1) * L])
        t1 = time.perf_counter()
        st._pending.append((arr, np.float32(1.0)))
        st._dispatch()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st._drain(st._inflight.popleft())
        t3 = time.perf_counter()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[name].append(1e3 * dt)
    for name, ms in stages.items():
        print(f"{name}: first block {ms[0]:.3f} ms, median of blocks "
              f"4-{args.blocks} {statistics.median(ms[3:]):.3f} ms "
              f"({card})", flush=True)
    print(f"frames {st.stats.frames}, su_ok {st.stats.su_ok}, "
          f"su_bad {st.stats.su_bad}", flush=True)

    state = st._state
    iq = torch.from_numpy(arr).cuda()
    scale = torch.tensor(np.float32(1.0), device="cuda")
    st._step(state, iq, scale)
    torch.cuda.synchronize()
    n = 10
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(n):
        st._step(state, iq, scale)
    ev1.record()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    step_ms = ev0.elapsed_time(ev1) / n
    print(f"step alone: host enqueue {enqueue_ms:.3f} ms, device (CUDA "
          f"events) {step_ms:.3f} ms per step over {n} steps ({card})",
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st._step(state, iq, scale)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    print(f"profiler over {n} steps: {len(dev) / n:.1f} device operations "
          f"per step, {busy_ms:.3f} ms of device time per step, device "
          f"idle {100 * (1 - busy_ms / step_ms):.1f}% of the CUDA-event "
          f"step ({card})", flush=True)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"op table: {os.path.relpath(args.out, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
