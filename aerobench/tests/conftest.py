"""Fixtures of the benchmark's own tests: tiny banks at 288 kS/s (12 kHz
filterbank bins for the L band, 24 kHz for the C band, as at full size)
that run on the CPU in seconds, and ``card`` for the tests that need a
CUDA card (they skip without one; the check is made here, never at
import).

    python3 -m pytest aerobench/tests -q
"""

from __future__ import annotations

import copy
import os
import time

import pytest
import torch

from aerobench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny runs share the host's cores between the test workers
torch.set_num_threads(1)


def tiny_lband() -> tuple:
    """4 P VFOs and 2 R watchers of the L-band configuration, at 288 kS/s,
    with its busy mix and R bursts."""
    cfg = run.load_json(os.path.join(HERE, "configs", "lband50.json"))
    cfg.update(sample_rate=288000,
               raster={"first_hz": cfg["center_frequency"] - 51000,
                       "spacing_hz": 18000},
               vfos=[{"kind": "P", "topic": "V{slot}", "slots": [0, 4],
                      "data_rate": 1200, "gain": 100},
                     {"kind": "R", "topic": "R{slot}", "slots": [4, 6],
                      "data_rate": 1200}])
    mix = run.load_json(os.path.join(HERE, "traffic", "lband_busy.json"))
    return cfg, mix


def tiny_cband() -> tuple:
    """3 P, 1 C and 2 T VFOs of the C-band configuration, at 288 kS/s,
    with its busy mix."""
    cfg = run.load_json(os.path.join(HERE, "configs", "cband44.json"))
    cfg.update(sample_rate=288000,
               raster={"first_hz": cfg["center_frequency"] - 95000,
                       "spacing_hz": 32000},
               vfos=[{"kind": "P", "topic": "P{slot:02d}", "slots": [0, 3],
                      "data_rate": 10500},
                     {"kind": "C", "topic": "C{slot:02d}", "slots": [3, 4],
                      "data_rate": 8400},
                     {"kind": "T", "topic": "T{slot:02d}", "slots": [5, 7],
                      "data_rate": 10500}])
    mix = run.load_json(os.path.join(HERE, "traffic", "cband_busy.json"))
    return cfg, mix


def run_tiny(cfg, mix, seed=4242424242, seconds=3.0, trace=False,
             specs=()):
    """One run of a tiny cell on the CPU: (result line, info)."""
    return run.run_cell({"name": "tiny"}, copy.deepcopy(cfg),
                        copy.deepcopy(mix), seed, seconds, trace, "cpu",
                        list(specs), t_process=time.perf_counter())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cell runs the port on it)")
    return torch.device("cuda")
