"""aero-decode CLI on PyTorch (ref: decode/main.cpp:12-107).

The same CLI as ``aero_tpu.runtime.decode_main``, one VFO: a ZMQ SUB
stream or an audio file through the demodulator, the framers, the signal
hunter and ACARS application decoding.  ``--device {cuda,cpu}`` (default
``cuda``) picks the demodulator's device and never falls back to the
CPU.  The JAX-only ``--platform`` and ``--compile-cache`` are absent.

Usage examples:
  python -m aero_tpu_torch.runtime.decode_main -b 1200 -p tcp://127.0.0.1:5555 -t VFO1
  python -m aero_tpu_torch.runtime.decode_main -b 1200 --input-file capture.wav
  python -m aero_tpu_torch.runtime.decode_main -b 600 -f jsondump=tcp://host:5571 ...
"""

from __future__ import annotations

import argparse
import socket
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aero-decode-torch",
        description="PyTorch/CUDA Inmarsat Aero demodulator/decoder")
    p.add_argument("-b", "--bit-rate", type=int, default=600,
                   choices=[600, 1200, 8400, 10500],
                   help="channel bit rate")
    p.add_argument("-f", "--forwarder", action="append", default=[],
                   metavar="FMT=URL",
                   help="forward decoded frames (tcp/udp), e.g. "
                        "jsondump=tcp://host:5571; repeatable")
    p.add_argument("-p", "--publisher", default="tcp://127.0.0.1:5555",
                   help="ZMQ publisher URL to consume")
    p.add_argument("-s", "--station-id",
                   default=f"{socket.gethostname()}-AERO-INMARSAT",
                   help="station id for output (ref: main.cpp:75-80)")
    p.add_argument("-t", "--topic", default="VFO1", help="ZMQ topic")
    p.add_argument("--burst", action="store_true",
                   help="burst (R/T channel) demodulation")
    p.add_argument("--disable-reassembly", action="store_true")
    p.add_argument("--format", default="jsondump",
                   choices=["jaero", "jsondump", "text"])
    p.add_argument("--no-signal-exit", action="store_true",
                   help="exit after a full futile frequency scan")
    p.add_argument("--input-file", default=None,
                   help="decode a WAV/raw-PCM file instead of ZMQ")
    p.add_argument("--input-rate", type=int, default=None,
                   help="sample rate for raw input files")
    p.add_argument("--aircraft-db", default=None, metavar="CSV",
                   help="aircraft registration DB CSV "
                        "(ICAO24,Registration,... — protocol/database.py)")
    p.add_argument("--voice-out", default=None,
                   help="write C-channel voice codec frames to this file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the demodulator; cuda without a usable "
                        "card is an error, never a CPU fallback")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from aero_tpu_torch.device import set_fp32_precision
    from aero_tpu_torch.runtime.decoder import Decoder, DecoderOptions

    opts = DecoderOptions(
        bitrate=args.bit_rate,
        burst=args.burst,
        station_id=args.station_id,
        fmt=args.format,
        # the reference's -f accepts a comma-separated list in one flag
        # (FORMAT1=URL1,FORMAT2=URL2; ref decode/main.cpp:26-29) — accept
        # both that form and repeated flags
        forwarders=[s for v in args.forwarder
                    for s in v.split(",") if s],
        disable_reassembly=args.disable_reassembly,
        no_signal_exit=args.no_signal_exit,
        voice_out=args.voice_out,
        aircraft_db=args.aircraft_db,
        verbose=args.verbose,
        device=args.device,
    )
    dec = Decoder(opts)
    set_fp32_precision()
    from aero_tpu_torch.utils.signals import EventNotifier
    notifier = EventNotifier().install()
    try:
        if args.input_file:
            dec.run_file(args.input_file, args.input_rate)
        else:
            dec.run_zmq(args.publisher, args.topic, notifier=notifier)
    finally:
        notifier.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
