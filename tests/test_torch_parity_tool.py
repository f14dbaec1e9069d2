"""The port's frame-parity and fixture tools on the CPU:
tools/torch_parity_check.py and tools/torch_make_fixture.py against the
committed fixtures and against JAX's tools/parity_check.py.

- The port's tool gives 100% parity on synthetic_1200 and synthetic_10500
  and >= 95% on the jaero-format intake drill (the thresholds of
  tests/test_parity_fixture.py), and on the two synthetic fixtures its
  decoded parity keys equal those of JAX's ``decode_capture``.
- On a wideband ``.cf32`` capture the port's tool gives JAX's tool's
  keys.
- ``torch_make_fixture.make`` writes WAVs equal byte for byte to the
  committed ones, and expected lists equal to the committed ones apart
  from the time stamp.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from tools import torch_make_fixture, torch_parity_check as tpc
from tools.frame_diff import _key

torch.set_num_threads(2)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@functools.lru_cache(maxsize=None)
def _port_lines(name, rate):
    return tuple(tpc.decode_capture(os.path.join(FIXDIR, f"{name}.wav"),
                                    bitrate=rate, device="cpu"))


@pytest.mark.parametrize("rate", [1200, 10500])
def test_port_tool_full_parity(rate):
    rep = tpc.parity(list(_port_lines(f"synthetic_{rate}", rate)),
                     os.path.join(FIXDIR, f"synthetic_{rate}.expected.jsonl"))
    assert rep["parity_pct"] == 100.0, rep
    assert rep["expected"] >= 3


def test_port_tool_cli_on_the_jaero_drill(capsys):
    rc = tpc.main([os.path.join(FIXDIR, "jaero_drill_1200.wav"),
                   os.path.join(FIXDIR, "jaero_drill_1200.expected.jsonl"),
                   "-b", "1200", "--min-parity", "95", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["parity_pct"] >= 95.0, rep
    assert set(rep) == {"parity_pct", "ours", "expected", "matched"}


@pytest.mark.parametrize("rate", [1200, 10500])
def test_port_keys_equal_jax_tool(rate):
    from tools.parity_check import decode_capture as jax_decode

    path = os.path.join(FIXDIR, f"synthetic_{rate}.wav")
    want = [_key(line) for line in jax_decode(path, bitrate=rate)]
    got = [_key(line) for line in _port_lines(f"synthetic_{rate}", rate)]
    assert got == want and len(got) >= 3


def _untimed(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in f if line.strip()]


@pytest.mark.parametrize("rate", [1200, 10500])
def test_make_fixture_regenerates_committed_fixture(tmp_path, rate):
    wav, exp = torch_make_fixture.make(str(tmp_path), rate=rate,
                                       device="cpu")
    name = f"synthetic_{rate}"
    with open(wav, "rb") as a, open(os.path.join(FIXDIR, f"{name}.wav"),
                                    "rb") as b:
        assert a.read() == b.read()
    assert _untimed(exp) == _untimed(os.path.join(
        FIXDIR, f"{name}.expected.jsonl"))


def test_port_tool_cf32_matches_jax_tool(tmp_path):
    """A wideband capture (``.cf32`` with its INI) through the port's
    FusedStation path: the same parity keys as JAX's tool, and 100%
    parity against JAX's decode written as the expected list."""
    from tools.parity_check import decode_capture as jax_decode
    import torch_impair as ti

    texts, wide = ti._wideband_msk_msgs(3, 288000, 24000)
    cap, ini = tmp_path / "wide.cf32", tmp_path / "wide.ini"
    wide.view(np.float32).tofile(cap)
    ini.write_text(ti.SLIP_INI)
    want = jax_decode(str(cap), ini=str(ini))
    exp = tmp_path / "wide.expected.jsonl"
    exp.write_text("".join(line + "\n" for line in want))
    got = tpc.decode_capture(str(cap), ini=str(ini), device="cpu")
    assert [_key(line) for line in got] == [_key(line) for line in want]
    assert {_key(line)[-1] for line in got} == set(texts)
    rep = tpc.parity(got, str(exp))
    assert rep["parity_pct"] == 100.0 and rep["expected"] == 3, rep
