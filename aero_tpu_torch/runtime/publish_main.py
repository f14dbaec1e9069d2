"""aero-publish CLI on PyTorch (ref: publish/main.cpp:11-64).

The same CLI as ``aero_tpu.runtime.publish_main``: a cf32 IQ file, raw
stdin or (when a SoapySDR python binding is present) a real device feeds
the tree ``Channelizer``, whose payloads go out on ZMQ in the reference's
topic framing, so aero-decode and JAERO consumers interoperate.  ``-d`` /
``--device`` stays the SoapySDR device string, as in the reference;
``--compute-device {cuda,cpu}`` (default ``cuda``) picks the
channelizer's device and never falls back to the CPU.  The JAX-only
``--platform`` and ``--compile-cache`` are absent.

Usage:
  python -m aero_tpu_torch.runtime.publish_main -c settings.ini --iq-file cap.cf32
  python -m aero_tpu_torch.runtime.publish_main -c settings.ini --iq-stdin
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aero-publish-torch",
        description="PyTorch/CUDA wideband channelizer/publisher")
    p.add_argument("-c", "--settings", required=True,
                   help="SDRReceiver-compatible INI file")
    p.add_argument("-d", "--device", default=None,
                   help="SoapySDR device string (if binding available)")
    p.add_argument("--enable-biast", action="store_true")
    p.add_argument("--enable-dcc", action="store_true",
                   help="enable DC bias correction")
    p.add_argument("--iq-file", default=None,
                   help="cf32 interleaved IQ capture to stream")
    p.add_argument("--iq-stdin", action="store_true",
                   help="read cf32 IQ from stdin")
    p.add_argument("--loop", action="store_true",
                   help="loop the IQ file forever")
    p.add_argument("--legacy-topic-len5", action="store_true",
                   help="reproduce the reference's 5-byte topic frames")
    p.add_argument("--compute-device", default="cuda",
                   choices=["cuda", "cpu"],
                   help="device of the channelizer; cuda without a usable "
                        "card is an error, never a CPU fallback")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from aero_tpu_torch.channelizer import load_ini, Channelizer
    from aero_tpu_torch.device import set_fp32_precision
    from aero_tpu_torch.io.zmq_transport import ZmqPublisher

    cfg = load_ini(args.settings)
    if args.enable_dcc:
        cfg.correct_dc_bias = True
    ch = Channelizer(cfg, device=args.compute_device)
    set_fp32_precision()
    pubs = {}

    def get_pub(address, bind):
        if address not in pubs:
            pubs[address] = ZmqPublisher(
                address, bind=bind, legacy_topic_len5=args.legacy_topic_len5)
        return pubs[address]

    main_pub = get_pub(cfg.zmq_address or "tcp://*:5555", True)

    def emit(outputs):
        for topic, rate, payload in outputs:
            if not topic:
                continue
            main_pub.publish(topic, rate, payload)

    B = cfg.buflen_complex
    from aero_tpu_torch.utils.signals import EventNotifier
    notifier = EventNotifier().install()

    def stream_blocks(reader):
        carry = np.zeros(0, np.complex64)
        for chunk in reader:
            if notifier.stop_requested:
                return
            carry = np.concatenate([carry, chunk])
            while len(carry) >= B:
                emit(ch.process(carry[:B]))
                carry = carry[B:]

    try:
        if args.device:
            from aero_tpu_torch.io.sdr import SoapyReader, soapy_available
            if not soapy_available():
                print("SoapySDR python binding not available; "
                      "use --iq-file/--iq-stdin", file=sys.stderr)
                return 2
            with SoapyReader(args.device, fs=cfg.sample_rate,
                             center_freq=cfg.center_frequency,
                             buflen_complex=B,
                             enable_biast=args.enable_biast,
                             enable_dcc=args.enable_dcc) as rdr:
                stream_blocks(iter(rdr))
        elif args.iq_file:
            def file_reader():
                while True:
                    data = np.fromfile(args.iq_file, dtype=np.complex64)
                    yield data
                    if not args.loop:
                        return
            stream_blocks(file_reader())
        elif args.iq_stdin:
            def stdin_reader():
                while True:
                    raw = sys.stdin.buffer.read(B * 8)
                    if not raw:
                        return
                    yield np.frombuffer(raw, np.complex64)
            stream_blocks(stdin_reader())
        else:
            print("no input: use --iq-file or --iq-stdin "
                  "(SoapySDR ingest requires the python binding)",
                  file=sys.stderr)
            return 2
    finally:
        notifier.uninstall()
        for pub in pubs.values():
            pub.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
