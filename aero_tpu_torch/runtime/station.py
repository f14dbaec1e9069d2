"""Station statistics and framer-event accounting (host code).

The parts of ``aero_tpu/runtime/station.py`` that the fused station
shares, copied verbatim (tests/test_torch_imports.py keeps them equal to
the originals).  The classic ``Station`` backend itself is not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import dataclass


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
