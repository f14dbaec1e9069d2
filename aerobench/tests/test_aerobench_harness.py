"""The harness finds every configuration, mix and metric by name, and its
last line has exactly the contract's keys."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from aerobench import run, traffic
from aerobench.trace import Trace
from conftest import run_tiny, tiny_lband

ROOT = run.ROOT
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    bench, spec, cfg, mix = run.load_cell(cell)
    assert spec["config"] == cfg["name"]
    assert mix["loop"] in ("closed", "paced")
    assert traffic.block_len(cfg) * mix["capture_blocks"] \
        % cfg["sample_rate"] == 0
    for trace in (False, True):
        specs = run.metrics_of(bench, cell, trace)
        assert specs, (cell, trace)
        if trace:
            for m in specs:
                assert callable(run.reader(m["name"]))


def test_configs_name_their_files_and_sources():
    for c in BENCH["configs"]:
        cfg = run.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) <= {"soft_mad", "soft_off", "audio_mad",
                                      "tel_rel", "flags"}
        # the reference it names has a RefStation; its keywords are a dict
        assert isinstance(run.reference_of(cfg), type)
        assert isinstance(cfg.get("station_args", {}), dict)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert run.reader(name)(Trace(kind="NVIDIA H100 80GB HBM3"), {}) is None


def test_the_last_line_has_the_contract_keys():
    cfg, mix = tiny_lband()
    bench = BENCH
    e2e = run.metrics_of(bench, "lband50.fill", False)
    out, _ = run_tiny(cfg, mix, seconds=2.0, specs=e2e)
    assert set(out) == KEYS | {"checks"}
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "realtime_x"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    pl = run.metrics_of(bench, "lband50.fill", True)
    out, _ = run_tiny(cfg, mix, seconds=2.0, trace=True, specs=pl)
    assert set(out) == KEYS | {"breakdown", "checks"}
    assert list(out)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: what needs one is left out
    assert "viterbi_roofline_pct" not in out["metrics"]
    assert {"ingest_ms", "drain_ms", "framers_ms"} <= set(out["metrics"])
    json.dumps(out)


def test_paced_line_reports_the_tails():
    cfg, mix = tiny_lband()
    mix["loop"], mix["rate"] = "paced", 1.0
    specs = [{"name": "emit_p50_ms", "unit": "ms"},
             {"name": "emit_p95_ms", "unit": "ms"},
             {"name": "setup_s", "unit": "s"}]
    out, info = run_tiny(cfg, mix, seconds=2.0, specs=specs)
    assert {"emit_p50_ms", "emit_p95_ms", "setup_s"} == set(out["metrics"])
    assert "feeder_late_ms" in info


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "aerobench.run", "--workload", "lband50.fill",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
