"""The comparison's control: the plain reference put in the station's
place and computed with TF32 allowed, the next step down from the
configuration's float32 with TF32 off, read by the same numbers a run
reads, against the reference in float32.

It follows a run's shape: the capture's first blocks from the initial
state, then, after the warm-up's passes, the window's first blocks from
the control's own state there (as a run's reference starts from the
station's state).  The benchmark's runs never run it; the tests under
``aerobench/tests`` do, and on a card at each cell's own size:

    python3 -m aerobench.control --workload lband50.busy --precision tf32 \
        --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from aerobench import check, traffic
from aerobench.run import load_cell, reference_of


def readings(cfg: dict, mix: dict, seed: int, precision: str, device,
             warm_passes: int = 2, compare_s: float = 4.0) -> dict:
    """The numbers of ``check.compare_packed`` for the control of one
    seed."""
    device = torch.device(device)
    tr = traffic.make(cfg, mix, seed, device)
    L, nb = tr.block_len, tr.blocks
    vfos = [(v.topic, v.offset_hz, v.data_rate, v.burst)
            for v in traffic.bank(cfg)]
    ingest = cfg["station"]["ingest_dtype"]
    hunt = cfg["station"]["hunt"]
    ref_station = reference_of(cfg)
    ctrl = ref_station(vfos, cfg["sample_rate"], ingest, hunt=hunt,
                       device=device, precision=precision)
    ref = ref_station(vfos, cfg["sample_rate"], ingest, hunt=hunt,
                      device=device)
    n_cmp = max(1, math.ceil(compare_s * cfg["sample_rate"] / L))

    def block(g):
        k = g % nb
        return tr.iq[k * L:(k + 1) * L]

    pairs = []
    s_c, s_r = ctrl.init_state(), ref.init_state()
    for b in range(n_cmp):
        s_c, p_c = ctrl.step(s_c, block(b))
        s_r, p_r = ref.step(s_r, block(b))
        pairs.append((p_c.cpu().numpy(), p_r.cpu().numpy()))
    for b in range(n_cmp, warm_passes * nb):
        s_c, _ = ctrl.step(s_c, block(b))
    s_r = ref.adopt(s_c)
    for b in range(warm_passes * nb, warm_passes * nb + n_cmp):
        s_c, p_c = ctrl.step(s_c, block(b))
        s_r, p_r = ref.step(s_r, block(b))
        pairs.append((p_c.cpu().numpy(), p_r.cpu().numpy()))
    return check.compare_packed(ref, pairs)


def fails(numbers: dict, limits: dict) -> list:
    """The numbers that exceed their limits."""
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aerobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--precision", default="tf32", choices=("fp32", "tf32"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, cell, cfg, mix = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("aerobench.control: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        nums = readings(cfg, mix, seed, args.precision, "cuda")
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "precision": args.precision, "readings": nums,
                          "fails": fails(nums, cfg["limits"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
