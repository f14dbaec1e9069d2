"""The yardstick of the kernels' rooflines: the card's peaks, and the
operations and bytes a kernel's work needs, counted from each launch's
real shape (rows and trellis steps), never from the padded one.

Peaks of the cards a run may name (``torch.cuda.get_device_name()``), at
their full power limit:

- NVIDIA H100 SXM (``NVIDIA H100 80GB HBM3``): 132 SMs, 64 INT32 lanes
  per SM (NVIDIA H100 Tensor Core GPU Architecture whitepaper: each of
  the SM's four partitions has 16 INT32 units), 1980 MHz maximum SM
  clock (the clock at which the data sheet's 67 TFLOP/s float32 = 132 x
  128 x 2 x 1.98 GHz holds): 132 x 64 x 1.98e9 = 16.727 TOP/s of int32
  add, compare or select; HBM3 at 3.35 TB/s (data sheet).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int32_ops": 132 * 64 * 1.98e9,
                              "bytes": 3.35e12},
}

# K=7 Viterbi, per trellis step of one stream: 4 branch metrics from 2
# soft bytes (6 integer operations) and, for each of the 64 states, two
# candidate sums, a compare and a select (the add-compare-select);
# renormalisation is a choice of the implementation and not counted
VITERBI_OPS_PER_STEP = 6 + 64 * 4
# each soft byte read once (2 per step), each decision bit written once
# as a byte (the kernel's output layout)
VITERBI_BYTES_PER_STEP = 2 + 1

VITERBI_KERNEL = "viterbi_k7_kernel"


def viterbi_work(launches) -> tuple:
    """[(rows, steps)] -> (operations, bytes)."""
    n = sum(rows * steps for rows, steps in launches)
    return VITERBI_OPS_PER_STEP * n, VITERBI_BYTES_PER_STEP * n


def share(ops: float, nbytes: float, seconds: float, kind: str):
    """The least time the work could take on ``kind`` over the time it
    took, in percent; None where the card has no entry or nothing ran."""
    peak = PEAKS.get(kind)
    if peak is None or seconds <= 0 or ops <= 0:
        return None
    least = max(ops / peak["int32_ops"], nbytes / peak["bytes"])
    return 100.0 * least / seconds
