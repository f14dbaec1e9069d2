"""Shared host wrapper for window-based burst demodulators (torch).

Counterpart of ``aero_tpu/models/burst_common.py``; read that module's
docstring for the detection design (an autocorrelation arm at the
preamble's coherence lag plus a power-envelope arm, each detection
anchoring a burst-extent gate whose complete runs become fixed-size
windows for the modulation's window demodulator).

``BurstWindowDemodulator.process`` is the JAX host logic, kept textually
equal to the original (tests/test_torch_imports.py compares the syntax
trees) apart from where arrays cross to the demodulator's ``device``: the
detection statistics (``_envelope``, ``_autocorr_rho``) and the window
function run on that device, and their results come back to the host as
numpy for the threshold and gate bookkeeping.  A demodulator built for
``cuda`` computes nothing of them on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.fir import convolve_same


@functools.lru_cache(maxsize=None)
def _box(n: int, device):
    """The length-n moving-average kernel (float32 ones / n)."""
    return torch.ones(n, dtype=torch.float32, device=device) / n


def _autocorr_rho(samples, lag: int, smooth: int):
    """Normalized analytic-signal autocorrelation magnitude at ``lag``:
    samples [n] tensor -> [n] on the same device."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    n = x.shape[-1]
    X = torch.fft.fft(x)
    f = torch.fft.fftfreq(n, device=x.device)
    h = torch.where(f > 0, 2.0, torch.where(f == 0, 1.0, 0.0))
    z = torch.fft.ifft(X * h.to(torch.complex64))
    zl = torch.cat([torch.zeros(x.shape[:-1] + (lag,), dtype=z.dtype,
                                device=x.device), z[..., :-lag]], dim=-1)
    prod = z * torch.conj(zl)
    k = _box(smooth, x.device)
    num = torch.abs(convolve_same(prod, k))
    den = convolve_same(torch.abs(z) ** 2, k)
    return num / torch.clamp(den, min=1e-12)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _bool_runs(mask: np.ndarray):
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)))


class BurstWindowDemodulator:
    def __init__(self, cfg, window_fn, rho_threshold: float = 0.35,
                 device="cuda"):
        self.cfg = cfg
        self._window_fn = window_fn
        self._ring = np.zeros(0, np.float32)
        self._noise_floor = 0.0
        self.rho_threshold = rho_threshold
        self.freq_center = float(cfg.freq_center)
        self.device = resolve_device(device)

    @property
    def state(self):                   # runtime/decoder compatibility
        return None

    def set_center(self, freq_center: float):
        """Hunter retune hook (ref decode.cpp:182,211 retunes burst demods
        too): shifts the per-window coarse-CFO search center."""
        self.freq_center = float(max(100.0, freq_center))

    def _smooth_len(self) -> int:
        return 8 * getattr(self.cfg, "sps", 20)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array onto the demodulator's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def process(self, samples: np.ndarray):
        from aero_tpu_torch.models.burst_msk import _envelope

        cfg = self.cfg
        sps = getattr(cfg, "sps", 20)
        samples = np.asarray(samples, np.float32)
        self._ring = np.concatenate([self._ring, samples])
        outs = []

        # detection statistics run over a zero-padded copy bucketed to a
        # 16384 multiple: the ring length changes after every consumed
        # burst, and jitting _envelope/_autocorr_rho per distinct length
        # would retrace+recompile FFT graphs on the decode path; the
        # coarse bucket keeps the steady-state shape set to a handful
        n_ring = len(self._ring)
        n_pad = max(16384, -(-n_ring // 16384) * 16384)
        padded = np.zeros(n_pad, np.float32)
        padded[:n_ring] = self._ring
        env = _host(_envelope(self._put(padded), self._smooth_len()))[:n_ring]
        q25 = float(np.percentile(env, 25.0)) if len(env) else 0.0
        if self._noise_floor <= 0:
            self._noise_floor = max(q25, 1e-12)
        else:
            self._noise_floor = 0.9 * self._noise_floor + 0.1 * min(
                q25, 4 * self._noise_floor)
        nf = self._noise_floor

        # ---- candidate detections ----
        lag = max(1, int(round(2.0 * cfg.fs / cfg.fb)))
        # integration floor in ABSOLUTE samples: at high symbol rates
        # (OQPSK 10500 @ 48k -> sps=4) 16*sps is only 64 samples, where
        # noise rho peaks at ~0.6 and false windows chop real bursts
        # (measured r3); 256 samples keeps noise max ~0.31 < threshold
        # while staying well under the shortest (96-bit) preamble
        det_smooth = max(16 * sps, 256)
        rho = _host(_autocorr_rho(self._put(padded), lag, det_smooth))[:n_ring]
        det = rho > self.rho_threshold
        min_det = max(6 * sps, det_smooth // 2)
        cands = [s for s, e in _bool_runs(det) if e - s >= min_det]
        # power arm: starts of strong gate runs (legacy high-SNR path)
        strong = env > (cfg.gate_ratio * nf)
        cands += [s for s, e in _bool_runs(strong)
                  if e - s >= 2 * self._smooth_len()]
        cands.sort()

        pad = self._smooth_len() // 2
        W = cfg.window_len
        consumed = 0
        for s in cands:
            if s < consumed:
                continue
            # burst extent: envelope thresholded between the noise floor
            # and the level measured around the detection.  The level is
            # a 75th percentile over 2*det_smooth samples, not a short
            # mean at the detection edge: the edge sits on the burst's
            # ramp-up, and an underestimated level puts the threshold
            # inside the noise distribution — the gap-bridging below
            # then chains across noise blips to the ring end and the
            # window defers until the burst scrolls out (r3 high-SNR
            # OQPSK failure)
            span = env[s: s + 2 * det_smooth]
            p_sig = float(np.percentile(span, 75.0)) if len(span) else nf
            thr = nf + 0.35 * max(p_sig - nf, 0.0)
            gate = env > max(thr, 1.5 * nf)
            runs_g = _bool_runs(gate)
            # the detection edge fires on the preamble ramp at a LOWER
            # level than the extent threshold, so the gate run may start
            # shortly AFTER s — accept the run containing s or the first
            # run starting within the detector's own integration length
            run = next(((gs, ge) for gs, ge in runs_g
                        if gs <= s < ge or s <= gs <= s + 2 * det_smooth),
                       None)
            if run is None:
                continue
            gs, ge = run
            # the burst envelope is constant (MSK/OQPSK); near threshold
            # the gate fragments on noise dips, which truncates long (T)
            # packets — extend the run FORWARD across gaps shorter than
            # ~4 smoothing windows (the start stays anchored at the
            # detection's own run, so the window never slides early)
            max_gap = 4 * self._smooth_len()
            for ns, ne in runs_g:
                if ns <= gs:
                    continue
                if ns - ge <= max_gap:
                    ge = max(ge, ne)
                else:
                    break
            # the burst may still be streaming in: a run that ends near the
            # ring end (within a bridgeable gap) can grow next block — wait
            # rather than emit a truncated window
            if len(gate) - ge <= max_gap + pad and ge - gs < W:
                continue
            if ge - gs < 2 * self._smooth_len():
                continue
            w0 = max(0, gs - pad)
            win = self._ring[w0: w0 + W]
            gwin = gate[w0: w0 + W].copy()
            # a burst is one contiguous transmission: noise dips punch
            # holes in the threshold gate near sensitivity, and a strobe
            # masked mid-burst DELETES a bit from the serialized stream
            # (fatal for the deinterleaver) — so fill the gate between its
            # first and last on-sample inside the window
            on = np.flatnonzero(gwin)
            if on.size:
                # ... and dilate the edges by the envelope smoothing
                # length: the smoothed-envelope threshold crossing sits
                # INSIDE the burst (later at the start, earlier at the
                # end, the more so the higher the threshold), and a
                # clipped tail starves the framer's last checkpoint
                # while extra noise strobes are harmless (UW search
                # skips them).  Measured r3: a high-SNR gate clipped
                # ~15 edge bits and T-packets stopped framing.
                edge = 2 * self._smooth_len()
                lo = max(0, int(on[0]) - edge)
                hi = min(len(gwin), int(on[-1]) + 1 + edge)
                gwin[lo:hi] = True
                ge = max(ge, min(w0 + hi, len(gate)))
            if len(win) < W:
                win = np.pad(win, (0, W - len(win)))
                gwin = np.pad(gwin, (0, W - len(gwin)))
            out = self._window_fn(self._put(win),
                                  self._put(gwin.astype(np.float32)),
                                  self.cfg, np.float32(self.freq_center))
            soft = _host(out["soft"])
            active = _host(out["active"])
            stream = []
            started = False
            for k in range(soft.shape[0]):
                if active[k]:
                    if not started:
                        stream.append(-1)
                        started = True
                    stream.extend(int(v) for v in soft[k])
            outs.append({
                "soft_bits": np.asarray(stream, np.int16),
                "burst": True,
                "signal": True,
                "freq": self.freq_center + float(out["freq_offset"]),
                "tone_quality": float(out["tone_quality"]),
            })
            consumed = max(consumed, min(ge + pad, len(self._ring)))

        # retained tail must cover the WIDEST window a deferred run can
        # still become: the deferral above waits on runs ending up to
        # max_gap + pad before the ring end, so a near-window-length
        # burst needs W + max_gap + 2*pad of history or its head is
        # trimmed before the window is ever emitted
        keep = W + 4 * self._smooth_len() + 2 * pad
        keep_from = max(consumed, len(self._ring) - keep)
        if keep_from > 0:
            self._ring = self._ring[keep_from:]
        if not outs:
            outs.append({
                "soft_bits": np.zeros(0, np.int16),
                "burst": False, "signal": False,
                "freq": self.freq_center, "tone_quality": 0.0,
            })
        return outs
