"""Station pipeline on torch: one process, one wideband stream, many VFOs.

Counterpart of ``aero_tpu/runtime/station.py``, the classic station:

    wideband IQ blocks
      -> Channelizer (batched mix + halfband cascades) or PfbChannelizer
      -> MskVfoBank / OqpskVfoBank: every same-rate VFO demodulated as one
         batched step, its rows sharded over the banks' mesh
      -> per-VFO host deframers and signal hunters -> SU dispatch -> ACARS

plus burst (R/T) watchers: host window demodulators whose detection
statistics and window functions run on the station's device, and R/T
framers whose checkpoint decodes run the CUDA Viterbi kernel there.

The statistics and framer-event accounting that the fused station shares
are copied verbatim (tests/test_torch_imports.py keeps them equal to the
originals).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from aero_tpu_torch.channelizer import ChannelizerConfig, Channelizer
from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.viterbi_kernel import stream_decoder
from aero_tpu_torch.parallel.vfo_bank import MskVfoBank, OqpskVfoBank
from aero_tpu_torch.protocol.framing import PChannelFramer
from aero_tpu_torch.protocol.su_dispatch import PChannelSUDispatcher
from aero_tpu_torch.runtime.hunter import SignalHunter


@dataclass
class StationStats:
    wideband_samples: int = 0
    wall_seconds: float = 0.0
    frames: int = 0
    su_ok: int = 0
    su_bad: int = 0
    acars: int = 0
    voice_frames: int = 0
    # burst (R/T) path observability: a dead burst watcher must be
    # distinguishable from a quiet channel (the reference emits per-demod
    # SignalStatus; ref decode/burstmskdemodulator.h signals)
    burst_windows: int = 0      # candidate windows that demodulated a burst
    burst_packets: int = 0      # R/T packets successfully framed

    @property
    def realtime_factor(self) -> float:
        return 0.0 if self.wall_seconds == 0 else \
            self.wideband_samples / self.wall_seconds


def new_burst_stats() -> dict:
    """Per-burst-VFO counters shared by Station and FusedStation."""
    return {"windows": 0, "packets": 0,
            "last_tone_quality": 0.0, "last_freq": 0.0}


def account_burst_outputs(stats: StationStats, burst_stats: dict,
                          outs, framer) -> int:
    """Run burst demod outputs through the R/T framer with full
    accounting: windows demodulated, packets framed, last tone quality
    and frequency.  Returns the number of packets framed."""
    packets = 0
    for out in outs:
        if not out["burst"]:
            continue
        burst_stats["windows"] += 1
        stats.burst_windows += 1
        burst_stats["last_tone_quality"] = float(out["tone_quality"])
        burst_stats["last_freq"] = float(out["freq"])
        for _ev in framer.feed(out["soft_bits"]):
            packets += 1
            burst_stats["packets"] += 1
            stats.burst_packets += 1
            stats.frames += 1
    return packets


def account_framer_events(stats: StationStats, data_rate: int, evs,
                          dispatcher=None) -> None:
    """Per-event bookkeeping shared by Station and FusedStation: P
    channels count SU CRCs and dispatch good SUs; the 8400 C channel
    counts signalling SU CRCs (voice frames go via on_voice sinks)."""
    for ev in evs:
        stats.frames += 1
        if data_rate == 8400:
            for _su, ok, _name in ev.signalling:
                if ok:
                    stats.su_ok += 1
                else:
                    stats.su_bad += 1
        else:
            for k, ok in enumerate(ev.su_crc_ok):
                if ok:
                    stats.su_ok += 1
                    if dispatcher is not None:
                        dispatcher.dispatch(
                            ev.infofield[k * 12:(k + 1) * 12])
                else:
                    stats.su_bad += 1


class Station:
    """The full chain's host side, on ``device``.

    ``mesh``: the demod banks' mesh (``parallel/mesh.py``); None gives
    each bank ``VfoBank``'s default for ``device``: with ``"cuda"`` every
    visible card that divides the bank, as JAX shards over every device.
    The channelizer, the burst watchers and their decodes stay on
    ``device``."""

    def __init__(self, cfg: ChannelizerConfig, on_acars=None, mesh=None,
                 station_id: str = "AERO-TPU", backend: str = "tree",
                 on_voice=None, aircraft_db=None, hunt: bool = True,
                 hunt_max_tries: int = 15, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.station_id = station_id
        self.on_voice = on_voice or (lambda vfo, data, hex_aes: None)
        if isinstance(aircraft_db, str):
            from aero_tpu_torch.protocol.database import DataBaseCSVUser
            aircraft_db = DataBaseCSVUser(aircraft_db)
        self._db = aircraft_db
        if backend == "pfb":
            from aero_tpu_torch.channelizer.pfb import PfbChannelizer
            self.channelizer = PfbChannelizer(cfg, device=self.device)
        else:
            self.channelizer = Channelizer(cfg, device=self.device)
        self.on_acars = on_acars or (lambda vfo, item: None)
        self.stats = StationStats()

        # group demodulatable sub VFOs by (out_rate, data_rate): each group
        # becomes one batched bank; every member gets its own deframer
        self.groups = defaultdict(list)
        self.burst_vfos = []
        for i, s in enumerate(cfg.subs):
            if getattr(s, "burst", False):
                if s.data_rate not in (600, 1200, 10500):
                    raise ValueError(
                        f"burst VFO {s.topic!r}: data_rate {s.data_rate} "
                        "not supported (R/T channels are 600/1200 MSK or "
                        "10500 OQPSK; ref decode/aerol.h:548-850)")
                self.burst_vfos.append(i)
            elif s.data_rate in (600, 1200, 8400, 10500):
                self.groups[(s.out_rate, s.data_rate)].append(i)
            else:
                # the reference rejects unknown rates at startup
                # (decode/main.cpp bitrate check); never drop silently
                raise ValueError(
                    f"VFO {s.topic!r}: unsupported data_rate {s.data_rate}")
        self.banks = {}
        self.framers = {}
        self.dispatchers = {}
        self._audio_buf = {}
        # per-VFO signal hunters, as the reference wires one per decode
        # process (ref: decode/decode.cpp:161-226, hunter.cpp:20-40);
        # disabled for burst VFOs like the reference (decode.cpp:174,204)
        self.hunters = {}
        for key, idxs in self.groups.items():
            out_rate, data_rate = key
            bank_cls = MskVfoBank if data_rate in (600, 1200) else OqpskVfoBank
            self.banks[key] = bank_cls(len(idxs), float(out_rate),
                                       float(data_rate), mesh=mesh,
                                       device=self.device)
            for i in idxs:
                topic = cfg.subs[i].topic
                if hunt:
                    h = SignalHunter(max_tries=hunt_max_tries)
                    if data_rate > 1200:
                        h.set_scan_range(0.0, 25000.0, 10500.0)  # C band
                    else:
                        h.set_scan_range(0.0, 6000.0, 900.0)     # L band
                    # scanned tunes must stay physical: cap below the
                    # audio Nyquist minus half the symbol rate
                    h.max_freq = min(h.max_freq,
                                     out_rate / 2.0 - data_rate / 2.0)
                    h.freq_center = float(self.banks[key].cfg.freq_center)
                    self.hunters[topic] = h
                if data_rate == 8400:
                    # C channel: voice + sub-band signalling, no ACARS
                    # (ref aerol.cpp:2145-2430 DecodeC)
                    from aero_tpu_torch.protocol.c_framing import (
                        CChannelFramer)
                    self.framers[topic] = CChannelFramer(
                        on_voice=self._mk_voice_sink(topic))
                else:
                    self.framers[topic] = PChannelFramer(data_rate)
                    self.dispatchers[topic] = PChannelSUDispatcher(
                        on_acars=self._mk_sink(topic), db=self._db)
                self._audio_buf[topic] = np.zeros(0, np.float32)

        # burst (R/T) VFOs: per-VFO window demodulators + R/T framers whose
        # checkpoint decodes run the Viterbi kernel on the station's device
        # (aero-tpu INI extension: '<n>\\burst=1')
        self.burst_demods = {}
        self.rt_framers = {}
        self.burst_stats = {}
        for i in self.burst_vfos:
            s = cfg.subs[i]
            if s.data_rate > 1200:
                from aero_tpu_torch.models.burst_oqpsk import (
                    BurstOqpskDemodulator)
                demod = BurstOqpskDemodulator(float(s.out_rate),
                                              float(s.data_rate),
                                              device=self.device)
            else:
                from aero_tpu_torch.models.burst_msk import BurstMskDemodulator
                demod = BurstMskDemodulator(float(s.out_rate),
                                            float(s.data_rate),
                                            device=self.device)
            from aero_tpu_torch.protocol.rt_framing import RTChannelFramer
            self.burst_demods[s.topic] = demod
            self.rt_framers[s.topic] = RTChannelFramer(
                oqpsk=s.data_rate > 1200,
                on_acars=self._mk_sink(s.topic), db=self._db,
                decoder=stream_decoder(self.device))
            self.burst_stats[s.topic] = new_burst_stats()

    def _mk_sink(self, topic):
        def sink(item):
            self.stats.acars += 1
            self.on_acars(topic, item)
        return sink

    def _mk_voice_sink(self, topic):
        def sink(data, hex_aes):
            self.stats.voice_frames += 1
            self.on_voice(topic, data, hex_aes)
        return sink

    def process(self, iq_block: np.ndarray):
        """Feed one wideband IQ block through the whole chain."""
        t0 = time.perf_counter()
        outputs = self.channelizer.process(iq_block)
        audio_by_topic = {}
        for topic, rate, payload in outputs:
            if topic in self.framers or topic in self.burst_demods:
                audio_by_topic[topic] = np.frombuffer(payload, "<i2").astype(
                    np.float32) / 32768.0

        for topic, demod in self.burst_demods.items():
            if topic in audio_by_topic:
                account_burst_outputs(
                    self.stats, self.burst_stats[topic],
                    demod.process(audio_by_topic[topic]),
                    self.rt_framers[topic])

        for key, idxs in self.groups.items():
            bank = self.banks[key]
            topics = [self.cfg.subs[i].topic for i in idxs]
            L = bank.cfg.block_len
            # accumulate per-topic audio until a full bank block is ready
            for t in topics:
                if t in audio_by_topic:
                    self._audio_buf[t] = np.concatenate(
                        [self._audio_buf[t], audio_by_topic[t]])
            if all(len(self._audio_buf[t]) >= L for t in topics):
                blocks = np.stack([self._audio_buf[t][:L] for t in topics])
                for t in topics:
                    self._audio_buf[t] = self._audio_buf[t][L:]
                out = bank.process_block(blocks)
                soft = out["soft_bits"].cpu().numpy()
                signal = out["signal"].cpu().numpy()
                slips = out["slip"].cpu().numpy()
                retune_rows, retune_freqs = [], []
                for row, t in enumerate(topics):
                    account_framer_events(
                        self.stats, key[1],
                        self.framers[t].feed(
                            soft[row].astype(np.float32),
                            slip=int(slips[row])),
                        self.dispatchers.get(t))
                    h = self.hunters.get(t)
                    if h is not None:
                        fr = self.framers[t]
                        h.update_dcd(bool(getattr(fr, "dcd", fr.locked)))
                        before = h.freq_center
                        h.update_signal_status(bool(signal[row]))
                        if h.freq_center != before:
                            tune = float(np.clip(h.freq_center, 100.0,
                                                 key[0] / 2.0 - 100.0))
                            retune_rows.append(row)
                            retune_freqs.append(tune)
                if retune_rows:
                    bank.retune(retune_rows, retune_freqs)

        self.stats.wideband_samples += len(iq_block)
        self.stats.wall_seconds += time.perf_counter() - t0

    @property
    def captures(self) -> int:
        """CUDA graphs captured by the station's device steps so far: the
        tree channelizer's group steps (the filterbank backend has none)
        and the demod banks'."""
        return (getattr(self.channelizer, "captures", 0)
                + sum(b.captures for b in self.banks.values()))

    # ---- checkpoint/resume (runtime/checkpoint.py) ----

    def device_state(self) -> dict:
        """The station's device-side carries as one tree of tensors, in
        the JAX station's layout: {"main", "sub", "banks"} for the tree
        channelizer or {"pfb", "phase", "banks"} for the filterbank, the
        banks keyed by ``repr`` of their (out_rate, data_rate) key."""
        ch = self.channelizer
        if isinstance(ch, Channelizer):
            tree = {"main": ch._main_state, "sub": ch._sub_state}
        else:
            tree = {"pfb": ch._state, "phase": ch._phase}
        tree["banks"] = {repr(k): b.states for k, b in self.banks.items()}
        return tree

    def set_device_state(self, tree: dict) -> None:
        """Inverse of ``device_state``: the tensors must already be on
        the station's device."""
        ch = self.channelizer
        if isinstance(ch, Channelizer):
            ch._main_state, ch._sub_state = tree["main"], tree["sub"]
        else:
            ch._state, ch._phase = tree["pfb"], tree["phase"]
        for k, bank in self.banks.items():
            bank.states = tree["banks"][repr(k)]

    def save_checkpoint(self, path: str, residual=None):
        """Write the full classic-station state (channelizer carries, bank
        demod states, audio accumulators, hunter positions, deframer locks
        and trellis history, reassembly buffers, stats) to one .npz in the
        JAX station's format.  ``residual`` stores caller-held wideband IQ
        (a partial block) so resume is sample-contiguous."""
        from aero_tpu_torch.runtime.checkpoint import save_classic_checkpoint
        save_classic_checkpoint(self, path, residual=residual)

    def load_checkpoint(self, path: str):
        """Resume from a classic checkpoint written by this station or the
        JAX one; the station must have the same VFO configuration
        (checked)."""
        from aero_tpu_torch.runtime.checkpoint import load_classic_checkpoint
        load_classic_checkpoint(self, path)
