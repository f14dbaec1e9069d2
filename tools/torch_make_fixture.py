#!/usr/bin/env python3
"""Generate the synthetic parity fixtures (tests/fixtures/) with the
PyTorch port, the counterpart of tools/make_fixture.py.

Synthesizes a P-channel WAV (1200 bps MSK or 10500 bps OQPSK) carrying
known ACARS messages with the port's modulators and frame functions, then
decodes it with the port's ``Decoder`` on ``--device`` and writes the
decoded jsondump lines as expected.jsonl, after checking that every
transmitted message text came back.  The WAVs are byte for byte the ones
tools/make_fixture.py writes.  Imports no JAX.

Usage: python tools/torch_make_fixture.py [outdir [rate]] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MESSAGES = [
    (0x4001AA, "VH-ABC", "H1", "PARITY FIXTURE MESSAGE ONE"),
    (0x4002BB, "N425SK", "AA", "MSG TWO: QUICK BROWN FOX 0123456789"),
    (0x4003CC, "C-FPAR", "B6", "THIRD AND FINAL PARITY MESSAGE"),
]


def make(outdir: str, name: str | None = None, rate: int = 1200,
         device: str = "cuda") -> tuple[str, str]:
    from aero_tpu_torch.device import set_fp32_precision
    from aero_tpu_torch.io.output import to_output_format
    from aero_tpu_torch.models.msk import msk_modulate
    from aero_tpu_torch.models.oqpsk import oqpsk_modulate
    from aero_tpu_torch.protocol.crc import append_crc16_bytes
    from aero_tpu_torch.protocol.framing import FRAME_SPECS, build_p_frames
    from aero_tpu_torch.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu_torch.runtime.decoder import Decoder, DecoderOptions

    name = name or f"synthetic_{rate}"
    fs = {600: 12000, 1200: 24000}.get(rate, 48000)
    per = FRAME_SPECS[rate].payload_info_bits // 96      # SUs per infofield
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    sus = []
    for aes, reg, label, text in MESSAGES:
        ud = make_acars_userdata("2", reg, "!", label, "A", text)
        sus += [append_crc16_bytes(b) for b in segment_isu(ud, aes, 0x41)]
    while len(sus) % per:
        sus.append(fill)
    fields = [b"".join(sus[i:i + per]) for i in range(0, len(sus), per)]
    bits = build_p_frames(fields, rate, lead_frames=3)
    if rate in (600, 1200):
        audio = msk_modulate(bits, fs, float(rate), freq=1000.0)
    else:
        audio = oqpsk_modulate(bits, fs, float(rate), freq=8000.0,
                               amplitude=0.4)
    rng = np.random.default_rng(0)
    audio = audio + rng.normal(0, 0.01, len(audio)).astype(np.float32)
    audio = np.concatenate([audio, np.zeros(2 * fs, np.float32)])

    os.makedirs(outdir, exist_ok=True)
    wav_path = os.path.join(outdir, f"{name}.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2")
                      .tobytes())

    set_fp32_precision()
    dec = Decoder(DecoderOptions(bitrate=rate, station_id="FIXTURE",
                                 device=device))
    with contextlib.redirect_stdout(io.StringIO()):
        dec.run_file(wav_path)
    texts = {item.message for item in dec.items}
    for _, _, _, text in MESSAGES:
        assert text in texts, f"TX message not recovered: {text!r}"

    exp_path = os.path.join(outdir, f"{name}.expected.jsonl")
    with open(exp_path, "w") as f:
        for item in dec.items:
            f.write(to_output_format("jsondump", "FIXTURE", False, item)
                    + "\n")
    return wav_path, exp_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?",
                    default=os.path.join(ROOT, "tests", "fixtures"))
    ap.add_argument("rate", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for rate in [args.rate] if args.rate else [1200, 10500]:
        wav, exp = make(args.outdir, rate=rate, device=args.device)
        print(f"wrote {wav} and {exp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
