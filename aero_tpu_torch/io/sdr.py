"""SoapySDR hardware ingest (gated: used only when the python binding
is importable; no SDR hardware exists in CI).

Mirrors the reference's device bring-up and reader loop
(ref: publish/publisher.cpp:27-38 device config — gain mode auto,
tuner gain 496, center frequency, sample rate, DC offset mode, bias-T
setting; publisher.cpp:234-283 CF32 blocking read loop with stream args
``buffers=24, bufflen=<buflen>``).

Usage:

    from aero_tpu_torch.io.sdr import SoapyReader, soapy_available
    rdr = SoapyReader("driver=rtlsdr", fs=1536000, center_freq=1545.1e6,
                      buflen_complex=384000, enable_biast=False,
                      enable_dcc=True)
    for block in rdr:          # np.complex64 arrays
        ...

The module also accepts an injected fake via ``set_backend`` so the
adapter logic is testable without hardware.
"""

from __future__ import annotations

import numpy as np

_backend = None


def set_backend(module) -> None:
    """Inject a SoapySDR-compatible module (tests / alternate bindings)."""
    global _backend
    _backend = module


def _get_backend():
    global _backend
    if _backend is None:
        try:
            import SoapySDR                       # type: ignore
            _backend = SoapySDR
        except ImportError:
            return None
    return _backend


def soapy_available() -> bool:
    return _get_backend() is not None


DEFAULT_TUNER_GAIN = 496.0        # ref: publish/publisher.cpp:19


class SoapyReader:
    """Blocking CF32 block reader over a SoapySDR device."""

    def __init__(self, device_str: str, fs: float, center_freq: float,
                 buflen_complex: int, enable_biast: bool = False,
                 enable_dcc: bool = False,
                 tuner_gain: float = DEFAULT_TUNER_GAIN):
        sdr = _get_backend()
        if sdr is None:
            raise RuntimeError(
                "SoapySDR python binding not available; use --iq-file/"
                "--iq-stdin or install SoapySDR")
        self._api = sdr
        self.buflen = int(buflen_complex)
        self.dev = sdr.Device(device_str)
        rx = sdr.SOAPY_SDR_RX
        self.dev.setGainMode(rx, 0, True)                  # publisher.cpp:33
        self.dev.setGain(rx, 0, tuner_gain)                # :34
        self.dev.setFrequency(rx, 0, float(center_freq))   # :35
        self.dev.setSampleRate(rx, 0, float(fs))           # :36
        self.dev.setDCOffsetMode(rx, 0, bool(enable_dcc))  # :37
        self.dev.writeSetting("biastee",
                              "true" if enable_biast else "false")  # :38
        self.stream = self.dev.setupStream(
            rx, sdr.SOAPY_SDR_CF32, [],
            {"buffers": "24", "bufflen": str(2 * self.buflen)})
        self.dev.activateStream(self.stream)
        self._buf = np.zeros(self.buflen, np.complex64)
        self._closed = False

    def read_block(self) -> np.ndarray | None:
        """One blocking read; None on stream error/end (ref loop breaks,
        publisher.cpp:270-274)."""
        sr = self.dev.readStream(self.stream, [self._buf], self.buflen,
                                 timeoutUs=int(1e7))
        n = sr.ret if hasattr(sr, "ret") else int(sr)
        if n <= 0:
            return None
        return self._buf[:n].copy()

    def __iter__(self):
        while True:
            block = self.read_block()
            if block is None:
                return
            yield block

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.dev.deactivateStream(self.stream)
            self.dev.closeStream(self.stream)
            self.dev.writeSetting("biastee", "false")  # publisher.cpp:49
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
