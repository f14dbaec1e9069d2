"""aero-station CLI on PyTorch: the full receive chain in one process.

The same CLI as ``aero_tpu.runtime.station_main``, with these differences:
``--backend`` takes ``fused`` only; ``--device {cuda,cpu}`` (default
``cuda``) picks the device and never falls back; ACARS application
decoding (``acars_apps.enrich``: ADS-C/CPDLC) is not run yet.  Flags of
what is not ported are absent rather than ignored: ``--checkpoint`` /
``--checkpoint-every`` (ROADMAP A8), and the JAX-only ``--platform`` /
``--compile-cache``.  Every VFO kind of the JAX fused station is served:
continuous MSK 600/1200 and OQPSK 10500 P channels, OQPSK 8400 C channels
(voice frames to ``--voice-out``) and burst R/T watchers at 600/1200/10500.

Usage:
  python -m aero_tpu_torch.runtime.station_main -c settings.ini \
      --iq-file wide.cf32 --batch-framing --device cuda
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aero-station-torch",
        description="PyTorch/CUDA full-chain Inmarsat Aero station "
                    "(P channels at 600/1200/10500, C channels at 8400, "
                    "burst R/T watchers; ACARS application decoding — "
                    "ADS-C/CPDLC enrichment — is not ported yet)")
    p.add_argument("-c", "--settings", required=True)
    p.add_argument("--iq-file", default=None, help="cf32 interleaved IQ")
    p.add_argument("--iq-stdin", action="store_true")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--backend", default="fused", choices=["fused"],
                   help="fused (the only backend of the port so far): "
                        "device-resident step per block")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the station's tensors; cuda without a "
                        "usable card is an error, never a CPU fallback")
    p.add_argument("--ingest-dtype", default="int16",
                   choices=["int2", "int4", "int8", "int16", "float32"],
                   help="host->device IQ quantization")
    p.add_argument("--format", default="jsondump",
                   choices=["jaero", "jsondump", "text"])
    p.add_argument("-s", "--station-id",
                   default=f"{socket.gethostname()}-AERO-INMARSAT")
    p.add_argument("-f", "--forwarder", action="append", default=[],
                   metavar="FMT=URL")
    p.add_argument("--stats-every", type=float, default=10.0,
                   help="seconds between stats lines on stderr")
    p.add_argument("--aircraft-db", default=None, metavar="CSV",
                   help="aircraft registration DB CSV "
                        "(ICAO24,Registration,... — protocol/database.py)")
    p.add_argument("--voice-out", default=None, metavar="FILE",
                   help="append C-channel voice codec frames (300 B per "
                        "frame, as decoded) to this file")
    p.add_argument("--batch-framing", action="store_true",
                   help="decode all P-channel frames of a rate group in "
                        "ONE batched call per drain (the CUDA Viterbi "
                        "kernel on the card)")
    p.add_argument("--no-hunt", action="store_true",
                   help="disable per-VFO signal hunting (the reference's "
                        "SignalHunter scan; ref decode/decode.cpp:161-226)")
    return p


def main(argv=None, on_station=None) -> int:
    """Run the CLI.  ``on_station(station)``, when given, is called once
    with the built ``FusedStation`` before any block is fed (for an
    embedding caller that inspects the station afterwards)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.device import resolve_device, set_fp32_precision
    from aero_tpu_torch.io.output import to_output_format
    from aero_tpu_torch.io.forwarder import (AsyncForwardQueue,
                                             ForwardTarget, parse_forwarder)
    from aero_tpu_torch.runtime.fused_station import FusedStation

    device = resolve_device(args.device)
    set_fp32_precision()
    cfg = load_ini(args.settings)
    targets = [ForwardTarget(parse_forwarder(s))
               for v in args.forwarder for s in v.split(",") if s]
    fwd = AsyncForwardQueue(targets) if targets else None

    def on_acars(topic, item):
        line = to_output_format(args.format, args.station_id, False, item)
        print(line, flush=True)
        if fwd is not None:
            fwd.submit(args.station_id, False, item)

    voice_f = open(args.voice_out, "ab") if args.voice_out else None

    def on_voice(topic, data, hex_aes):
        if voice_f is not None:
            voice_f.write(data)
            voice_f.flush()

    st = FusedStation(cfg, on_acars=on_acars, on_voice=on_voice,
                      station_id=args.station_id,
                      ingest_dtype=args.ingest_dtype,
                      aircraft_db=args.aircraft_db, hunt=not args.no_hunt,
                      batch_host_framing=args.batch_framing, device=device)
    if on_station is not None:
        on_station(st)
    B = st.block_len
    last_stats = time.time()

    # SIGINT/SIGTERM stop the pump cleanly; SIGHUP dumps a stats line
    from aero_tpu_torch.utils.signals import EventNotifier

    def hup_stats():
        s = st.stats
        dump = {"wideband_samples": s.wideband_samples, "frames": s.frames,
                "su_ok": s.su_ok, "su_bad": s.su_bad, "acars": s.acars,
                "burst_windows": s.burst_windows,
                "burst_packets": s.burst_packets,
                "vfos": st.vfo_telemetry()}
        print(json.dumps({"stats_on_sighup": dump}),
              file=sys.stderr, flush=True)

    notifier = EventNotifier(on_hangup=hup_stats).install()

    def pump(reader):
        nonlocal last_stats
        carry = np.zeros(0, np.complex64)
        for chunk in reader:
            if notifier.stop_requested:
                break
            carry = np.concatenate([carry, chunk])
            while len(carry) >= B:
                st.process(carry[:B])
                carry = carry[B:]
            if time.time() - last_stats >= args.stats_every:
                last_stats = time.time()
                s = st.stats
                print(json.dumps({
                    "stats": {
                        "wideband_samples": s.wideband_samples,
                        "realtime_factor": round(
                            s.realtime_factor / cfg.sample_rate, 2),
                        "frames": s.frames, "su_ok": s.su_ok,
                        "su_bad": s.su_bad, "acars": s.acars,
                        "burst_windows": s.burst_windows,
                        "burst_packets": s.burst_packets,
                    }}), file=sys.stderr, flush=True)
        st.flush()

    if args.iq_file:
        def reader():
            while True:
                yield np.fromfile(args.iq_file, dtype=np.complex64)
                if not args.loop:
                    return
        pump(reader())
    elif args.iq_stdin:
        def reader():
            while True:
                raw = sys.stdin.buffer.read(B * 8)
                if not raw:
                    return
                yield np.frombuffer(raw, np.complex64)
        pump(reader())
    else:
        print("no input: use --iq-file or --iq-stdin", file=sys.stderr)
        return 2

    s = st.stats
    final = {"wideband_samples": s.wideband_samples,
             "frames": s.frames, "su_ok": s.su_ok, "su_bad": s.su_bad,
             "acars": s.acars, "device": str(device)}
    if fwd is not None:
        fwd.flush()
        fwd.close()
        final["forwarded"] = fwd.sent
        final["forward_dropped"] = fwd.dropped
        final["forward_errors"] = fwd.errors
    if voice_f is not None:
        final["voice_frames"] = s.voice_frames
        voice_f.close()
    print(json.dumps({"final_stats": final}), file=sys.stderr)
    notifier.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
