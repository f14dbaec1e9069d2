"""Port parity for the CLI: ``aero_tpu_torch.runtime.station_main``.

On a cf32 file of the bank of tests/torch_station_bank.py, the port's CLI
with ``--device cpu`` prints the same jsondump records as JAX's
``station_main --platform cpu`` (timestamps aside), JAX's with batch
framing off and on (the port has the one path, no flag).  On a one-VFO
8400 C-channel INI carrying two frames, ``--voice-out`` writes the same
bytes as JAX's.  ``--device cuda`` without
a usable card raises instead of falling back to the CPU.
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
    jax_flags = ["--platform", "cpu"] + (["--batch-framing"] if batch else [])
    assert jax_main.main(common + jax_flags) == 0
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


def test_cli_voice_out_same_bytes_as_jax(tmp_path, capsys):
    """The C8400 VFO of tests/test_fused_mixed.py alone at 288 kS/s, two
    C frames of known voice: both CLIs append the same 300-byte frames."""
    from aero_tpu.models.oqpsk import oqpsk_modulate
    from aero_tpu.protocol.c_framing import build_c_frames
    from tests.test_c_channel import _frames
    from tests.test_fused_mixed import CENTER, FS, _to_wideband

    ini = tmp_path / "c.ini"
    ini.write_text(f"[General]\nsample_rate={FS}\n"
                   f"center_frequency={CENTER}\n[vfos]\nsize=1\n"
                   f"1\\frequency={CENTER + 96000}\n1\\data_rate=8400\n"
                   "1\\topic=C8400\n")
    rng = np.random.default_rng(9)
    frames = _frames(rng, 2)
    dur = 6 * FS
    wb = _to_wideband(oqpsk_modulate(build_c_frames(frames, lead_frames=3),
                                     48000, 8400, freq=8000.0),
                      48000, 96000, dur // 6)
    wb = np.concatenate([wb, np.zeros(dur - len(wb), np.complex64)])
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)
    iq = tmp_path / "c.cf32"
    wb.tofile(iq)
    common = ["-c", str(ini), "--iq-file", str(iq), "--stats-every", "1e9"]
    jv, tv = tmp_path / "jax.voice", tmp_path / "torch.voice"
    assert jax_main.main(common + ["--platform", "cpu",
                                   "--voice-out", str(jv)]) == 0
    assert torch_main.main(common + ["--device", "cpu",
                                     "--voice-out", str(tv)]) == 0
    err = capsys.readouterr().err
    got = tv.read_bytes()
    assert got == jv.read_bytes()
    assert len(got) % 300 == 0
    voices = [got[i:i + 300] for i in range(0, len(got), 300)]
    assert [f[1] for f in frames] == [v for v in voices
                                      if v in {f[1] for f in frames}]
    assert '"voice_frames": %d' % (len(got) // 300) in err


@pytest.mark.parametrize("flag", [["--compile-cache", "cache"],
                                  ["--platform", "cpu"],
                                  ["--batch-framing"]])
def test_cli_refuses_unported_flags(capture, flag):
    """The JAX-only flags are absent, not silently ignored (the port's
    fused station always frames through its banks)."""
    ini, iq = capture
    with pytest.raises(SystemExit):
        torch_main.main(["-c", ini, "--iq-file", iq, "--device", "cpu"]
                        + flag)
