"""aero-station CLI on PyTorch: the full receive chain in one process.

The same CLI as ``aero_tpu.runtime.station_main``, with
``--device {cuda,cpu}`` (default ``cuda``), which picks the device and
never falls back to the CPU.  ``--backend fused`` (default) is the
device-resident station; ``--backend tree`` / ``pfb`` the classic one
(tree channelizer or polyphase filterbank, then batched demod banks).
Every VFO kind is served: continuous MSK 600/1200 and OQPSK 10500 P
channels, OQPSK 8400 C channels (voice frames to ``--voice-out``) and
burst R/T watchers at 600/1200/10500; each ACARS item goes through the
ACARS application decoders (ADS-C, CPDLC) before it is printed.
``--checkpoint`` resumes from and saves to a checkpoint in the JAX
station's format.  ``--trace`` switches the port's tracer on
(``utils/profiling.py``): the stats lines and the SIGHUP dump then carry
each stage's self ms per drained block and each counter's change since
the last line.  ``--pfb-oversample 4`` builds the fused station on the
4x filterbank plan (``FusedStation(pfb_oversample=4)``), which holds a
VFO anywhere in its bin; 2, the default, is JAX's plan.  The JAX-only
``--platform`` / ``--compile-cache`` are absent.

Usage:
  python -m aero_tpu_torch.runtime.station_main -c settings.ini \
      --iq-file wide.cf32 --batch-framing --device cuda
  python -m aero_tpu_torch.runtime.station_main -c settings.ini \
      --iq-file wide.cf32 --backend tree --checkpoint st.ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

from aero_tpu_torch.utils.profiling import TRACER


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aero-station-torch",
        description="PyTorch/CUDA full-chain Inmarsat Aero station "
                    "(P channels at 600/1200/10500, C channels at 8400, "
                    "burst R/T watchers)")
    p.add_argument("-c", "--settings", required=True)
    p.add_argument("--iq-file", default=None, help="cf32 interleaved IQ")
    p.add_argument("--iq-stdin", action="store_true")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--backend", default="fused",
                   choices=["tree", "pfb", "fused"],
                   help="fused (default): device-resident step per block; "
                        "tree/pfb: the classic reference-shaped station "
                        "(a channelizer, then one demod bank per rate)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the station's tensors; cuda without a "
                        "usable card is an error, never a CPU fallback")
    p.add_argument("--ingest-dtype", default="int16",
                   choices=["int2", "int4", "int8", "int16", "float32"],
                   help="fused backend host->device IQ quantization")
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
                   help="fused backend: decode all P-channel frames of a "
                        "rate group, and all C-channel frames, in ONE "
                        "batched call per drain (the CUDA Viterbi kernel "
                        "on the card)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="resume from FILE at startup when it exists, and "
                        "save the full station state there periodically "
                        "and at shutdown (runtime/checkpoint.py; the JAX "
                        "station's format)")
    p.add_argument("--checkpoint-every", type=float, default=300.0,
                   metavar="SEC", help="seconds between checkpoint saves")
    p.add_argument("--no-hunt", action="store_true",
                   help="disable per-VFO signal hunting (the reference's "
                        "SignalHunter scan; ref decode/decode.cpp:161-226)")
    p.add_argument("--pfb-oversample", type=int, default=2, choices=(2, 4),
                   help="the fused station's filterbank plan: 2 (JAX's: "
                        "K = 2 fs / channel rate, hop K/2) or 4 (K = 4 fs "
                        "/ channel rate, hop K/4: a VFO anywhere in its "
                        "bin keeps its band)")
    p.add_argument("--trace", action="store_true",
                   help="trace the station: the stats lines and the "
                        "SIGHUP dump carry each stage's self ms per "
                        "drained block and each counter's change since "
                        "the last line")
    return p


def trace_reading() -> dict:
    """What the tracer recorded since the last reading: blocks drained,
    each stage's self ms per drained block, the counters' changes."""
    return TRACER.take().per_block_ms()


def main(argv=None, on_station=None) -> int:
    """Run the CLI.  ``on_station(station)``, when given, is called once
    with the built station (``FusedStation`` or ``Station``) before any
    block is fed (for an embedding caller that inspects the station
    afterwards)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.pfb_oversample != 2 and args.backend != "fused":
        parser.error("--pfb-oversample is the fused station's plan; "
                     f"--backend {args.backend} has its own channelizer")
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.device import resolve_device, set_fp32_precision
    from aero_tpu_torch.io.output import to_output_format
    from aero_tpu_torch.io.forwarder import (AsyncForwardQueue,
                                             ForwardTarget, parse_forwarder)
    from aero_tpu_torch.protocol.acars_apps import enrich

    device = resolve_device(args.device)
    set_fp32_precision()
    if args.trace:
        TRACER.take()
        TRACER.on = True
    cfg = load_ini(args.settings)
    targets = [ForwardTarget(parse_forwarder(s))
               for v in args.forwarder for s in v.split(",") if s]
    fwd = AsyncForwardQueue(targets) if targets else None

    def on_acars(topic, item):
        enrich(item)
        line = to_output_format(args.format, args.station_id, False, item)
        print(line, flush=True)
        if fwd is not None:
            fwd.submit(args.station_id, False, item)

    voice_f = open(args.voice_out, "ab") if args.voice_out else None

    def on_voice(topic, data, hex_aes):
        if voice_f is not None:
            voice_f.write(data)
            voice_f.flush()

    def mk_station():
        if args.backend == "fused":
            from aero_tpu_torch.runtime.fused_station import FusedStation
            return FusedStation(cfg, on_acars=on_acars, on_voice=on_voice,
                                station_id=args.station_id,
                                ingest_dtype=args.ingest_dtype,
                                aircraft_db=args.aircraft_db,
                                hunt=not args.no_hunt,
                                batch_host_framing=args.batch_framing,
                                pfb_oversample=args.pfb_oversample,
                                device=device)
        from aero_tpu_torch.runtime.station import Station
        n_vfos = len(cfg.mains) + len(cfg.subs)
        if n_vfos > 8:
            print(f"warning: --backend {args.backend} is the classic "
                  f"comparison shape; {n_vfos} VFOs may not keep up with "
                  f"real time — the default fused backend is the "
                  f"production path", file=sys.stderr)
        return Station(cfg, on_acars=on_acars, on_voice=on_voice,
                       station_id=args.station_id, backend=args.backend,
                       aircraft_db=args.aircraft_db,
                       hunt=not args.no_hunt, device=device)

    st = mk_station()
    B = st.block_len if args.backend == "fused" else cfg.buflen_complex
    initial_carry = np.zeros(0, np.complex64)
    if args.checkpoint and os.path.exists(args.checkpoint):
        # a truncated/incompatible checkpoint must not crash-loop the
        # station: warn and start fresh (the periodic save will replace
        # it atomically — runtime/checkpoint.py _atomic_savez)
        try:
            st.load_checkpoint(args.checkpoint)
            from aero_tpu_torch.runtime.checkpoint import load_residual
            initial_carry = load_residual(args.checkpoint)
            print(json.dumps({"resumed_from": args.checkpoint,
                              "residual_samples": len(initial_carry)}),
                  file=sys.stderr, flush=True)
        except Exception as e:
            print(json.dumps({"checkpoint_load_failed": str(e),
                              "action": "starting fresh"}),
                  file=sys.stderr, flush=True)
            # a failed load can leave the station HALF-restored (device
            # state assigned before a later framer blob raised): rebuild
            # so "starting fresh" means what it says
            st = mk_station()
    if on_station is not None:
        on_station(st)
    last_ckpt = time.time()
    last_stats = time.time()

    # SIGINT/SIGTERM stop the pump cleanly; SIGHUP dumps a stats line
    from aero_tpu_torch.utils.signals import EventNotifier

    def hup_stats():
        s = st.stats
        dump = {"wideband_samples": s.wideband_samples, "frames": s.frames,
                "su_ok": s.su_ok, "su_bad": s.su_bad, "acars": s.acars,
                "burst_windows": s.burst_windows,
                "burst_packets": s.burst_packets}
        # fused backend: per-VFO signal/mse/ebno/freq + burst counters
        if hasattr(st, "vfo_telemetry"):
            dump["vfos"] = st.vfo_telemetry()
        if args.trace:
            dump["trace"] = trace_reading()
        print(json.dumps({"stats_on_sighup": dump}),
              file=sys.stderr, flush=True)

    notifier = EventNotifier(on_hangup=hup_stats).install()

    carry_box = [initial_carry]     # pump residual, persisted in ckpts

    def pump(reader):
        nonlocal last_stats, last_ckpt
        carry = carry_box[0]
        for chunk in reader:
            if notifier.stop_requested:
                break
            carry = np.concatenate([carry, chunk])
            while len(carry) >= B:
                st.process(carry[:B])
                carry = carry[B:]
            carry_box[0] = carry
            if (args.checkpoint
                    and time.time() - last_ckpt >= args.checkpoint_every):
                last_ckpt = time.time()
                st.save_checkpoint(args.checkpoint, residual=carry)
            if time.time() - last_stats >= args.stats_every:
                last_stats = time.time()
                s = st.stats
                line = {
                    "wideband_samples": s.wideband_samples,
                    "realtime_factor": round(
                        s.realtime_factor / cfg.sample_rate, 2),
                    "frames": s.frames, "su_ok": s.su_ok,
                    "su_bad": s.su_bad, "acars": s.acars,
                    "burst_windows": s.burst_windows,
                    "burst_packets": s.burst_packets,
                }
                if args.trace:
                    line["trace"] = trace_reading()
                print(json.dumps({"stats": line}), file=sys.stderr,
                      flush=True)
        if hasattr(st, "flush"):
            st.flush()       # drain the pipelined in-flight blocks

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
    if args.checkpoint:
        st.save_checkpoint(args.checkpoint, residual=carry_box[0])
        final["checkpoint"] = args.checkpoint
    print(json.dumps({"final_stats": final}), file=sys.stderr)
    notifier.uninstall()
    if args.trace:
        TRACER.on = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
