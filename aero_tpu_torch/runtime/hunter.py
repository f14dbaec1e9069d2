"""Signal hunter: frequency-scan controller.

Behavioral equivalent of SignalHunter (ref: decode/hunter.{h,cpp}): counts
consecutive no-signal reports from the demodulator; every ``max_tries``
misses it steps the center frequency by bandwidth/2 across
[min_freq, max_freq]; a full wrap with no signal raises ``on_no_signal``.
DCD transitions are edge-detected to reset the try counter.

Parameter sets from the reference orchestrator (decode/decode.cpp:161-198):
C-band (0, 25000, 10500); L-band (0, 6000, 900); max_tries 15.
"""

from __future__ import annotations

from typing import Callable


class SignalHunter:
    def __init__(self, max_tries: int = 15,
                 on_new_center: Callable | None = None,
                 on_no_signal_after_scan: Callable | None = None):
        self.max_tries = max_tries
        self.on_new_center = on_new_center or (lambda f: None)
        self.on_no_signal_after_scan = on_no_signal_after_scan or (lambda: None)
        self.min_freq = 0.0
        self.max_freq = 6000.0
        self.bandwidth = 900.0
        self.freq_center = 0.0
        self.tries = 0
        self.scanned_all = False
        self._dcd = False
        self.enabled = True

    def set_scan_range(self, min_freq: float, max_freq: float,
                       bandwidth: float):
        self.min_freq = min_freq
        self.max_freq = max_freq
        self.bandwidth = bandwidth
        self.freq_center = min_freq
        self.tries = 0
        self.scanned_all = False

    def update_dcd(self, dcd: bool):
        """Edge-detected DCD resets the counter (ref: hunter.cpp:14-19)."""
        if dcd != self._dcd:
            self._dcd = dcd
            self.tries = 0

    def update_signal_status(self, has_signal: bool):
        if not self.enabled:
            return
        if has_signal:
            self.tries = 0
            self.scanned_all = False
            return
        self.tries += 1
        if self.tries < self.max_tries:
            return
        self.tries = 0
        self.freq_center += self.bandwidth / 2.0
        if self.freq_center > self.max_freq:
            self.freq_center = self.min_freq
            if self.scanned_all:
                self.on_no_signal_after_scan()
            self.scanned_all = True
        self.on_new_center(self.freq_center)
