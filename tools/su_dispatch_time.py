#!/usr/bin/env python3
"""Time SU dispatch on the host, with the display line and without.

    python3 tools/su_dispatch_time.py [CHECKOUT] [--reps N] [--seed S]

CHECKOUT is the root of a checkout of this repository (default: the one
that holds this file).  Its ``aero_tpu_torch`` dispatcher is timed, so
that two versions can be compared in one run on one host: run them as
A, B, B, A.  The SUs are a ``cband_busy`` pass's, as
``aerobench/traffic.py:_p_frames`` makes them (this file's checkout's
``aerobench``): 32 P VFOs at 10500 bps, 64 frames of 26 SUs each, two
ACARS messages a frame of 8-40 characters, the rest fill.  Each VFO's
SUs go through a dispatcher of its own, as in the fused station, and each
ACARS item through the benchmark's callback (``enrich``, then
``to_output_format("jsondump")``).  The host needs no card.

Modes: ``display`` (the default dispatcher, which formats each SU's
display line) and, where the checkout's dispatcher takes the keyword,
``route`` (``display=False``, as the fused station builds it).  Each
mode runs ``N`` times in the order on, off, off, on, ...; each run's time
is the whole pass's dispatch over its SUs.  Prints per mode the median
and range of us an SU, and ms per 550 SUs (a ``cband44feeder.busy``
block's), checks that both modes give the same jsondump lines, and then
one JSON line with the host's CPU, the counts and the times.
"""

from __future__ import annotations

import inspect
import json
import os
import platform
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1760000000.25
SUS_PER_BLOCK = 550


def _cpu() -> str:
    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} cores"


def busy_sus(seed: int, vfos: int = 32) -> list:
    """Each VFO's 12-byte SUs of one ``cband_busy`` pass."""
    import numpy as np
    from aerobench import tx
    from aerobench.traffic import _p_frames, _reg
    rng = np.random.default_rng(seed)
    spec = {"acars_frame_share": 1.0, "messages_per_frame": 2,
            "text_len": [8, 40]}
    n_frames = 32 * 10500 // tx.p_frame_bits(10500)
    taken, out = set(), []
    for v in range(vfos):
        fields, _ = _p_frames(rng, 10500, n_frames, spec, v,
                              0x400000 + 0x100 * v + 1, _reg(rng), taken)
        out.append([f[k:k + 12] for f in fields
                    for k in range(0, len(f), 12)])
    return out


def run_once(cls, streams, **kw) -> tuple:
    """One pass: (seconds, jsondump lines)."""
    from aero_tpu_torch.io.output import to_output_format
    from aero_tpu_torch.protocol.acars_apps import enrich
    lines = []

    def on_acars(item):
        enrich(item)
        lines.append(to_output_format("jsondump", "AERO-TPU", False, item,
                                      now=NOW))
    dispatchers = [cls(on_acars=on_acars, **kw) for _ in streams]
    t0 = time.perf_counter()
    for d, sus in zip(dispatchers, streams):
        dispatch = d.dispatch
        for su in sus:
            dispatch(su)
    return time.perf_counter() - t0, lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps, seed, checkout = 6, 2222000401, ROOT
    it = iter(argv)
    for a in it:
        if a == "--reps":
            reps = int(next(it))
        elif a == "--seed":
            seed = int(next(it))
        else:
            checkout = os.path.abspath(a)
    sys.path[:0] = [checkout] + ([ROOT] if checkout != ROOT else [])
    from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher
    streams = busy_sus(seed)
    n = sum(len(s) for s in streams)
    modes = {"display": {}}
    if "display" in inspect.signature(PChannelSUDispatcher).parameters:
        modes["route"] = {"display": False}
    times = {m: [] for m in modes}
    lines = {}
    order = list(modes)
    run_once(PChannelSUDispatcher, streams)             # warm up
    for r in range(reps):
        for m in (order if r % 2 == 0 else order[::-1]):
            dt, got = run_once(PChannelSUDispatcher, streams, **modes[m])
            times[m].append(dt)
            if lines.setdefault(m, got) != got:
                raise SystemExit(f"{m}: the lines changed between runs")
    if len({tuple(v) for v in lines.values()}) != 1:
        raise SystemExit("display and route gave different jsondump lines")
    n_lines = len(lines["display"])
    out = {"checkout": checkout, "host": _cpu(),
           "python": platform.python_version(), "sus": n,
           "lines": n_lines, "seed": seed, "reps": reps, "modes": {}}
    print(f"host {out['host']}; {n} SUs, {n_lines} jsondump lines, "
          f"seed {seed}, {reps} runs a mode")
    for m, ts in times.items():
        us = [1e6 * t / n for t in ts]
        med = statistics.median(us)
        out["modes"][m] = {"us_per_su": us, "median_us_per_su": med,
                           "ms_per_block": med * SUS_PER_BLOCK / 1e3}
        print(f"{m:8s} {med:7.3f} us an SU ({min(us):.3f}-{max(us):.3f}), "
              f"{med * SUS_PER_BLOCK / 1e3:6.3f} ms per {SUS_PER_BLOCK} SUs")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
