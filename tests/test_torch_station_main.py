"""Port parity for the CLI: ``aero_tpu_torch.runtime.station_main``.

On a cf32 file of the bank of tests/torch_station_bank.py, the port's CLI
with ``--device cpu`` prints the same jsondump records as JAX's
``station_main --platform cpu`` (timestamps aside), with batch framing
off and on.  ``--device cuda`` without a usable card raises instead of
falling back to the CPU.
"""

import json

import numpy as np
import pytest
import torch

from aero_tpu.runtime import station_main as jax_main
from aero_tpu_torch.runtime import station_main as torch_main
from torch_station_bank import INI, make_wideband

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ini = d / "bank.ini"
    ini.write_text(INI)
    iq = d / "wide.cf32"
    wb = make_wideband()
    # two silent blocks flush the last frames through the pipeline
    np.concatenate([wb, np.zeros(2 * 384000, np.complex64)]).tofile(iq)
    return str(ini), str(iq)


def _records(out: str):
    recs = []
    for line in out.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            r.pop("t", None)
            recs.append(r)
    return recs


@pytest.mark.parametrize("batch", [False, True])
def test_cli_same_jsondump_as_jax(capture, capsys, batch):
    ini, iq = capture
    common = ["-c", ini, "--iq-file", iq, "--format", "jsondump",
              "-s", "TEST", "--stats-every", "1e9"]
    common += ["--batch-framing"] if batch else []
    assert jax_main.main(common + ["--platform", "cpu"]) == 0
    want = _records(capsys.readouterr().out)
    seen = []
    assert torch_main.main(common + ["--device", "cpu"],
                           on_station=seen.append) == 0
    got = _records(capsys.readouterr().out)
    assert len(want) >= 2
    assert sorted(map(json.dumps, got)) == sorted(map(json.dumps, want))
    assert seen and seen[0].device.type == "cpu"


def test_cli_cuda_without_card_raises(capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ini, iq = capture
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main.main(["-c", ini, "--iq-file", iq, "--device", "cuda"])


@pytest.mark.parametrize("flag", [["--checkpoint", "x.npz"],
                                  ["--voice-out", "v.bin"],
                                  ["--platform", "cpu"]])
def test_cli_refuses_unported_flags(capture, flag):
    """Flags of what is not ported are absent, not silently ignored."""
    ini, iq = capture
    with pytest.raises(SystemExit):
        torch_main.main(["-c", ini, "--iq-file", iq, "--device", "cpu"]
                        + flag)
