"""A configuration's two optional keys: ``reference`` names the module of
``aerobench/ref`` whose ``RefStation`` the run is held to, and
``station_args`` holds keywords that go to the station as they stand,
so that a program that lacks one refuses the configuration at once
(``run.main`` exits 5 and prints no result)."""

from __future__ import annotations

import ast
import os
import sys
import types

import pytest
import torch

from aerobench import run, traffic
from aerobench.ref import step
from conftest import run_tiny, tiny_lband

REF_DIR = os.path.join(run.HERE, "ref")
REF_FILES = sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py"))
CONFIG_FILES = sorted(os.listdir(os.path.join(run.HERE, "configs")))


def tiny_paced() -> tuple:
    """The tiny L-band bank fed on a schedule: the window holds the same
    blocks in every run, so two runs give the same counts."""
    cfg, mix = tiny_lband()
    mix["loop"], mix["rate"] = "paced", 2.0
    return cfg, mix


def test_naming_the_default_reference_changes_nothing():
    cfg, mix = tiny_paced()
    out, _ = run_tiny(cfg, mix, seconds=2.0)
    cfg["reference"] = "step"
    named, _ = run_tiny(cfg, mix, seconds=2.0)
    assert out["correct"] and named["correct"]
    for k in ("checks", "attempted", "failed"):
        assert named[k] == out[k], k


class OneByteOff(step.RefStation):
    """The plain step with the first soft byte of its first continuous
    group inverted."""

    def step(self, state, iq):
        state, packed = super().step(state, iq)
        pos = next(self.layout[k][0] for k in self.order if not k[2])
        packed = packed.clone()
        packed[pos] = 255 - packed[pos]
        return state, packed


def test_the_named_reference_is_the_one_compared(monkeypatch):
    mod = types.ModuleType("aerobench.ref.one_byte_off")
    mod.RefStation = OneByteOff
    monkeypatch.setitem(sys.modules, "aerobench.ref.one_byte_off", mod)
    cfg, mix = tiny_lband()
    cfg["reference"] = "one_byte_off"
    assert run.reference_of(cfg) is OneByteOff
    out, _ = run_tiny(cfg, mix, seconds=2.0)
    assert not out["correct"]
    assert out["checks"]["soft_mad"]["value"] > \
        out["checks"]["soft_mad"]["limit"]


def test_a_keyword_the_program_has_passes_through():
    cfg, mix = tiny_lband()
    cfg["station_args"] = {"hunt_max_tries": 7}
    assert run.build_station(cfg, None, None, "cpu").hunt_max_tries == 7
    # the reference's hunter steps after 6 misses, as the station's default
    cfg["station_args"] = {"hunt_max_tries": 6}
    out, _ = run_tiny(cfg, mix, seconds=2.0)
    assert out["correct"], out["checks"]


def test_an_unknown_keyword_is_refused_and_the_run_exits_5(monkeypatch,
                                                           capsys):
    cfg, _ = tiny_lband()
    cfg["station_args"] = {"no_such_option": 1}
    with pytest.raises(run.Refused, match="no_such_option"):
        run.build_station(cfg, None, None, "cpu")

    load_cell = run.load_cell

    def with_args(name):
        bench, cell, cfg, mix = load_cell(name)
        cfg["station_args"] = {"no_such_option": 1}
        return bench, cell, cfg, mix

    def fake_run_cell(cell, cfg, *args):
        run.build_station(cfg, None, None, "cpu")
        raise AssertionError("the station was built")

    monkeypatch.setattr(run, "load_cell", with_args)
    monkeypatch.setattr(run, "run_cell", fake_run_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", "lband50.fill", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    got = capsys.readouterr()
    assert rc == 5 and got.out == ""
    assert "aerobench: the program cannot build configuration lband50: " \
        in got.err and "no_such_option" in got.err


def test_other_errors_of_the_station_are_not_refusals():
    # without station_args the constructor's errors propagate as before
    cfg, _ = tiny_lband()
    cfg["vfos"][0]["data_rate"] = 2400
    with pytest.raises(ValueError, match="unsupported data_rate"):
        run.build_station(cfg, None, None, "cpu")


def _imports(path: str) -> list:
    """The modules a file imports, by full dotted name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("name", REF_FILES)
def test_a_reference_module_takes_nothing_of_the_program(name):
    for mod in _imports(os.path.join(REF_DIR, name)):
        top = mod.split(".")[0]
        assert top not in set(run.BANNED) | {"aero_tpu_torch"}, mod
        if top == "aerobench":
            assert mod == "aerobench.ref" or \
                mod.startswith("aerobench.ref."), mod


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_a_configuration_reference_keeps_the_wire_layout(name):
    # check.py reads every reference's rows with step's TEL_SLOTS
    cfg = run.load_json(os.path.join(run.HERE, "configs", name))
    vfos = [(v.topic, v.offset_hz, v.data_rate, v.burst)
            for v in traffic.bank(cfg)]
    ref = run.reference_of(cfg)(vfos, cfg["sample_rate"],
                                cfg["station"]["ingest_dtype"], device="cpu")
    assert ref.packed_len == ref.soft_total + 4 * step.TEL_SLOTS * len(vfos)
