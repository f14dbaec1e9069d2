#!/usr/bin/env python3
"""ACARS frame-parity harness on the PyTorch port (BASELINE's >= 95%
metric), the counterpart of tools/parity_check.py.

Decodes a capture with ``aero_tpu_torch`` on ``--device`` and reports what
fraction of the expected messages came back, matched as
tools/frame_diff.py matches them (either reference output format in the
expected list; ``parity`` is JAX's, which tests/test_torch_imports.py
holds equal).  A ``.wav`` goes through the single-VFO ``Decoder``; a
``.cf32`` (interleaved float32 wideband IQ) through the ``FusedStation``
of the channelizer INI given with ``-c``, its ACARS enriched as
``station_main`` enriches them.  Imports no JAX.

Usage:
    python tools/torch_parity_check.py capture.wav expected.jsonl -b 1200
    python tools/torch_parity_check.py wide.cf32 expected.jsonl -c settings.ini
    ... --device cpu           (default cuda; without a card that raises)

Prints a human summary on stderr and ONE JSON line on stdout:
    {"parity_pct": 100.0, "ours": 3, "expected": 3, "matched": 3}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from aero_tpu_torch.device import set_fp32_precision  # noqa: E402
from aero_tpu_torch.io.output import to_output_format  # noqa: E402


def decode_capture(path: str, bitrate: int = 1200, ini: str | None = None,
                   device: str = "cuda",
                   station_id: str = "PARITY") -> list[str]:
    """Decode a capture file on ``device``; returns jsondump lines."""
    set_fp32_precision()
    lines = []
    if path.endswith(".cf32"):
        from aero_tpu_torch.channelizer import load_ini
        from aero_tpu_torch.protocol.acars_apps import enrich
        from aero_tpu_torch.runtime.fused_station import FusedStation
        if not ini:
            raise ValueError("cf32 captures need a channelizer INI (-c)")
        items = []
        st = FusedStation(load_ini(ini), device=device,
                          on_acars=lambda t, item: items.append(item))
        raw = np.fromfile(path, np.float32)
        wb = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
        wb = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
        for i in range(0, (len(wb) // st.block_len) * st.block_len,
                       st.block_len):
            st.process(wb[i:i + st.block_len])
        st.flush()
        for item in items:
            enrich(item)
            lines.append(to_output_format("jsondump", station_id, False,
                                          item))
    else:
        from aero_tpu_torch.runtime.decoder import Decoder, DecoderOptions
        dec = Decoder(DecoderOptions(bitrate=bitrate, station_id=station_id,
                                     device=device))
        with contextlib.redirect_stdout(io.StringIO()):
            dec.run_file(path)
        for item in dec.items:
            lines.append(to_output_format("jsondump", station_id, False,
                                          item))
    return lines


def parity(ours_lines: list[str], expected_path: str) -> dict:
    """expected.jsonl accepts BOTH reference output formats: jsondump
    (nested isu) and the jaero flat JSON (AESID/GESID/LABEL/REG, no
    text; ref decode/output.cpp:107-127) — with jaero expectations the
    match drops message text from both sides."""
    from tools.frame_diff import _key, keys_comparable
    ours_keys = [k for k in (_key(ln) for ln in ours_lines) if k]
    expected = []
    with open(expected_path) as f:
        for line in f:
            k = _key(line.strip())
            if k:
                expected.append(k)
    ours, exp_set = keys_comparable(ours_keys, expected)
    matched = ours & exp_set
    return {
        "parity_pct": round(100.0 * len(matched) / max(1, len(exp_set)), 1),
        "ours": len(ours),
        "expected": len(exp_set),
        "matched": len(matched),
        "missing": sorted(exp_set - ours)[:10],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("capture")
    ap.add_argument("expected")
    ap.add_argument("-b", "--bitrate", type=int, default=1200)
    ap.add_argument("-c", "--ini", default=None)
    ap.add_argument("--min-parity", type=float, default=None,
                    help="exit 1 below this percentage")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the decode; cuda without a usable card "
                         "is an error, never a CPU fallback")
    args = ap.parse_args(argv)
    ours = decode_capture(args.capture, args.bitrate, args.ini, args.device)
    rep = parity(ours, args.expected)
    missing = rep.pop("missing")
    for m in missing:
        print(f"missing: {m}", file=sys.stderr)
    print(f"parity {rep['parity_pct']}% "
          f"({rep['matched']}/{rep['expected']} expected messages; "
          f"we decoded {rep['ours']})", file=sys.stderr)
    print(json.dumps(rep))
    if args.min_parity is not None and rep["parity_pct"] < args.min_parity:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
