"""The decoder runtime on torch: demodulator -> deframer -> SU dispatch ->
ACARS -> output/forwarders for one VFO stream.

Counterpart of ``aero_tpu/runtime/decoder.py`` (the reference's Decoder
orchestrator, decode/decode.cpp:72-455), with the demodulator on
``DecoderOptions.device`` (default ``cuda``; no CPU fallback):

  600/1200 continuous  -> MskDemodulator   + PChannelFramer  (P channel)
  10500 continuous     -> OqpskDemodulator + PChannelFramer  (C-band P)
  8400                 -> OqpskDemodulator + CChannelFramer  (C channel)
  600/1200 burst       -> BurstMskDemodulator   + RTChannelFramer
  10500 burst          -> BurstOqpskDemodulator + RTChannelFramer (oqpsk)

The R/T framer's checkpoint decodes run the CUDA Viterbi kernel on the
decoder's device (its plain-torch twin on the CPU).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.protocol.framing import PChannelFramer
from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher
from aero_tpu_torch.io.output import to_output_format
from aero_tpu_torch.io.forwarder import (AsyncForwardQueue, ForwardTarget,
                                         parse_forwarder)
from aero_tpu_torch.runtime.hunter import SignalHunter


def fs_for_bitrate(bitrate: int) -> int:
    """ref: decode/decode.cpp:145."""
    return {600: 12000, 1200: 24000}.get(bitrate, 48000)


@dataclass
class DecoderOptions:
    bitrate: int = 600
    burst: bool = False
    station_id: str = "AERO-TPU"
    fmt: str = "jsondump"
    forwarders: list = field(default_factory=list)
    disable_reassembly: bool = False
    no_signal_exit: bool = False
    voice_out: str | None = None
    verbose: int = 0
    aircraft_db: str | None = None     # CSV path (protocol/database.py)
    device: str = "cuda"


class Decoder:
    def __init__(self, opts: DecoderOptions):
        self.opts = opts
        self.device = resolve_device(opts.device)
        self.fs = fs_for_bitrate(opts.bitrate)
        self.items = []
        self.voice_frames = 0
        self._voice_file = open(opts.voice_out, "wb") if opts.voice_out else None
        self.targets = [ForwardTarget(parse_forwarder(s))
                        for s in opts.forwarders]
        # egress decoupled from decode: a stalled sink only fills the
        # bounded queue (drop-oldest), never the decode loop
        # (ref decode.cpp:368-416 forwarder thread)
        self.fwd_queue = AsyncForwardQueue(self.targets) \
            if self.targets else None
        self._make_demod()
        self._make_framing()
        # hunter: the reference counts ~6 signal reports/s with maxTries 15
        # (~2.5 s per step); we report once per ~0.7 s block, so 4 tries
        # give the same dwell
        self.hunter = SignalHunter(
            max_tries=4,
            on_new_center=self._set_center,
            on_no_signal_after_scan=self._no_signal)
        if opts.bitrate > 1200:
            self.hunter.set_scan_range(0, 25000, 10500)   # C band
        else:
            self.hunter.set_scan_range(0, 6000, 900)      # L band
        self._buf = np.zeros(0, np.float32)
        self._no_signal_flag = False

    # ---- construction ----

    def _make_demod(self):
        opts, dev = self.opts, self.device
        if opts.burst:
            if opts.bitrate > 1200:
                from aero_tpu_torch.models.burst_oqpsk import (
                    BurstOqpskDemodulator)
                self.demod = BurstOqpskDemodulator(
                    self.fs, float(opts.bitrate), device=dev)
            else:
                from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
                self.demod = BurstMskDemodulator(
                    self.fs, float(opts.bitrate), device=dev)
        elif opts.bitrate in (600, 1200):
            from aero_tpu_torch.models.msk import MskDemodulator
            self.demod = MskDemodulator(self.fs, float(opts.bitrate),
                                        device=dev)
        else:
            from aero_tpu_torch.models.oqpsk import OqpskDemodulator
            self.demod = OqpskDemodulator(self.fs, float(opts.bitrate),
                                          device=dev)

    def _make_framing(self):
        opts = self.opts
        self.framer = None
        self.rt_framer = None
        self.c_framer = None
        db = None
        if opts.aircraft_db:
            from aero_tpu_torch.protocol.database import DataBaseCSVUser
            db = DataBaseCSVUser(opts.aircraft_db)
        if opts.burst:
            from aero_tpu_torch.ops.viterbi_kernel import stream_decoder
            from aero_tpu_torch.protocol.rt_framing import RTChannelFramer
            self.rt_framer = RTChannelFramer(
                oqpsk=opts.bitrate > 1200,
                on_acars=self.handle_acars,
                on_fragment=self._handle_fragment,
                on_error=self._handle_error,
                db=db, decoder=stream_decoder(self.device))
        elif opts.bitrate == 8400:
            from aero_tpu_torch.protocol.c_framing import CChannelFramer
            self.c_framer = CChannelFramer(on_voice=self._handle_voice)
        else:
            self.framer = PChannelFramer(opts.bitrate)
            self.dispatcher = PChannelSUDispatcher(
                on_acars=self.handle_acars,
                on_fragment=self._handle_fragment,
                on_error=self._handle_error,
                downlink=False,
                db=db)

    # ---- control ----

    def _set_center(self, freq_center: float):
        st = self.demod.state
        if st is None:
            # burst demods: shift the per-window CFO search center
            # (ref retunes burst demods too, decode.cpp:182,211)
            self.demod.set_center(freq_center)
            return

        def full(v):          # one value on the state's [1] VFO axis
            return torch.full_like(st.freq, v)
        # slope/grid_rate belong to the old signal (see vfo_bank.retune)
        self.demod.state = st._replace(
            freq=full(float(np.float32(max(freq_center, 100.0)))),
            mse=full(2.0), slope=full(0.0), grid_rate=full(0.0))

    def _no_signal(self):
        self._no_signal_flag = True

    def _handle_error(self, msg):
        print(msg, file=sys.stderr)

    def _handle_voice(self, data: bytes, hex_aes: str):
        self.voice_frames += 1
        if self._voice_file:
            self._voice_file.write(data)

    def _handle_fragment(self, item):
        if self.opts.disable_reassembly:
            self.handle_acars(item)

    # ---- data path ----

    def feed_audio(self, payload: bytes, sample_rate: int):
        """PCM int16 audio chunk from the wire."""
        if sample_rate != self.fs:
            # adapt like the reference (mskdemodulator.cpp:473-481)
            print(f"sample rate change {self.fs} -> {sample_rate}",
                  file=sys.stderr)
            self.fs = sample_rate
            self._make_demod()
        pcm = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        self._buf = np.concatenate([self._buf, pcm])
        L = self.demod.cfg.block_len
        while len(self._buf) >= L:
            block, self._buf = self._buf[:L], self._buf[L:]
            for out in self.demod.process(block):
                self._consume(out)

    def _consume(self, out):
        self.hunter.update_signal_status(bool(out["signal"]))
        soft = np.asarray(out["soft_bits"])
        if self.rt_framer is not None:
            for ev in self.rt_framer.feed(soft.astype(np.int16)):
                if self.opts.verbose and ev.display:
                    print(ev.display)
            self.hunter.update_dcd(bool(out["signal"]))
            return
        # timing-grid slips are realigned at the framer boundary
        soft = soft.astype(np.float32)
        slip = int(out.get("slip", 0))
        if self.c_framer is not None:
            for ev in self.c_framer.feed(soft, slip=slip):
                if self.opts.verbose:
                    for su, ok, name in ev.signalling:
                        if ok and name != "Fill_in_signal_unit":
                            print(f"C: {name} "
                                  f"{su[:10].hex().upper()}")
            self.hunter.update_dcd(self.c_framer.locked)
            return
        for ev in self.framer.feed(soft, slip=slip):
            for k, ok in enumerate(ev.su_crc_ok):
                if ok:
                    line = self.dispatcher.dispatch(
                        ev.infofield[k * 12:(k + 1) * 12])
                    if self.opts.verbose and line:
                        print(line)
        self.hunter.update_dcd(self.framer.dcd)

    def handle_acars(self, item):
        from aero_tpu_torch.protocol.acars_apps import enrich
        enrich(item)   # libacars-equivalent app decode (ref decode.cpp:401)
        self.items.append(item)
        line = to_output_format(self.opts.fmt, self.opts.station_id,
                                self.opts.disable_reassembly, item)
        print(line, flush=True)
        if self.fwd_queue is not None:
            self.fwd_queue.submit(self.opts.station_id,
                                  self.opts.disable_reassembly, item)

    def close(self):
        """Flush and stop the forwarder worker; close outputs."""
        if self.fwd_queue is not None:
            self.fwd_queue.flush()
            self.fwd_queue.close()
            self.fwd_queue = None
        if self._voice_file:
            self._voice_file.close()
            self._voice_file = None

    # ---- run loops ----

    def run_zmq(self, url: str, topic: str, notifier=None):
        """Consume the publisher stream until EOF-equivalent conditions:
        a futile full scan (with no_signal_exit) or a shutdown request
        from ``notifier`` (utils.signals.EventNotifier, the reference's
        common/notifier.cpp SIGINT/SIGTERM bridge)."""
        from aero_tpu_torch.io.zmq_transport import ZmqSubscriber
        sub = ZmqSubscriber(url, topic)
        try:
            while not (notifier and notifier.stop_requested):
                msg = sub.recv(timeout_ms=100)
                if msg is not None:
                    _, rate, payload = msg
                    self.feed_audio(payload, rate)
                if self._no_signal_flag and self.opts.no_signal_exit:
                    break
        finally:
            sub.close()
            self.close()

    def run_file(self, path: str, sample_rate: int | None = None):
        """Decode a PCM int16 raw file or WAV file, then flush."""
        if path.endswith(".wav"):
            import wave
            with wave.open(path, "rb") as w:
                rate = w.getframerate()
                data = w.readframes(w.getnframes())
        else:
            rate = sample_rate or self.fs
            with open(path, "rb") as f:
                data = f.read()
        self.feed_audio(data, rate)
        # flush with silence so trailing frames decode
        pad = np.zeros(2 * self.demod.cfg.block_len, np.float32)
        self.feed_audio((pad * 32767).astype("<i2").tobytes(), rate)
        self.close()
