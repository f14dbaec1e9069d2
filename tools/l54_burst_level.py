#!/usr/bin/env python3
"""The weakest R burst that configs/aor_w_54_lband.ini's burst watchers
decode, on the PyTorch port's classic station.

Run from the root of a checkout:

    python3 tools/l54_burst_level.py [--device cuda] [--amplitudes 1,3,10,30]

For each amplitude it builds the 54W capture of tests/torch_lband54.py
with its R burst on RCH01 at that amplitude (the P signals are at 1.0,
the capture's own burst at 30), runs a fresh classic tree ``Station`` on
the file, unmodified, over the blocks around the burst, and prints
whether the planted R packet came out, with the watcher's burst windows
and packets.  The last line names the lowest amplitude that decoded.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# the burst starts in block 20 (5 s); the station runs blocks 12-23
FIRST, N_BLOCKS = 12, 24


def decodes(base: np.ndarray, amplitude: float, device: str):
    """(R packet decoded, burst windows, packets) at ``amplitude``."""
    import torch_lband54 as l54
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.station import Station
    wide = base + l54.r_burst(len(base), amplitude)
    st = Station(load_ini(l54.INI_PATH), device=device)
    for b in range(FIRST, N_BLOCKS):
        st.process(wide[b * l54.BLOCK:(b + 1) * l54.BLOCK])
    ok = any(e.kind == "R" and e.infofield[:17] == l54.R_INFO
             for e in st.rt_framers[l54.R_TOPIC].events)
    return ok, st.stats.burst_windows, st.stats.burst_packets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--amplitudes", default="1,2,3,5,7,10,15,20,30")
    args = p.parse_args(argv)
    import torch_lband54 as l54
    from aero_tpu_torch.device import set_fp32_precision
    set_fp32_precision()
    base = l54.make_capture(N_BLOCKS, r_amplitude=0.0)
    lowest = None
    for a in sorted(float(x) for x in args.amplitudes.split(",")):
        ok, windows, packets = decodes(base, a, args.device)
        print(f"R burst amplitude {a:g} (P signals 1): decoded {ok}, burst "
              f"windows {windows}, packets {packets} ({args.device})",
              flush=True)
        if ok and lowest is None:
            lowest = a
    print(f"lowest amplitude that decoded: {lowest} ({args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
