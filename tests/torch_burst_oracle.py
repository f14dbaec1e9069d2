"""The parent commit's ``BurstWindowDemodulator.process``: the host-loop
oracle of the burst watchers' tests.

``HostLoop`` keeps the ring and the noise floor on the host and runs the
detection as it ran before the port moved it to the device: every block
pads the ring, runs the port's plain ``_envelope`` and ``_autocorr_rho``
on the demodulator's device, takes both back, and scans them with numpy
(``np.percentile``, ``_bool_runs``).  Its window demodulation is the
demodulator's own graphed window step.  ``process`` below is that
method's text, unchanged; it imports neither JAX nor the JAX package, so
that the card's tests (run without them) use it too.
"""

import numpy as np
import torch

from aero_tpu_torch.models import burst_common as tbc
from aero_tpu_torch.models import burst_msk as tbm


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _bool_runs(mask: np.ndarray):
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)))


class HostLoop:
    """A host-ring twin of the burst demodulator ``dm``: its
    configuration, threshold, center and window step, with a ring and a
    noise floor of its own."""

    def __init__(self, dm):
        self.dm = dm
        self.cfg = dm.cfg
        self.rho_threshold = dm.rho_threshold
        self._ring = np.zeros(0, np.float32)
        self._noise_floor = 0.0
        self.last = {}                  # the last block's statistics
        dev = dm.device

        def envelope(x, smooth):
            self.last["env"] = tbm._envelope(x.to(dev), smooth)
            return self.last["env"]

        def autocorr_rho(x, lag, smooth):
            self.last["rho"] = tbc._autocorr_rho(x.to(dev), lag, smooth)
            return self.last["rho"]
        self._envelope, self._autocorr_rho = envelope, autocorr_rho
        self._window_fn = dm._window_fn

    def candidates(self, n_ring: int) -> int:
        """The candidate detections of the last block, whose ring held
        ``n_ring`` samples: what ``process`` sorts and scans."""
        cfg, sps = self.cfg, getattr(self.cfg, "sps", 20)
        env = _host(self.last["env"])[:n_ring]
        rho = _host(self.last["rho"])[:n_ring]
        det_smooth = max(16 * sps, 256)
        min_det = max(6 * sps, det_smooth // 2)
        det = rho > self.rho_threshold
        strong = env > (cfg.gate_ratio * self._noise_floor)
        return (sum(e - s >= min_det for s, e in _bool_runs(det))
                + sum(e - s >= 2 * self._smooth_len()
                      for s, e in _bool_runs(strong)))

    @property
    def freq_center(self) -> float:
        return self.dm.freq_center

    def _smooth_len(self) -> int:
        return self.dm._smooth_len()

    def _put(self, a) -> torch.Tensor:
        return self.dm._put(a)

    def process(self, samples: np.ndarray):
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
        env = _host(self._envelope(self._put(padded),
                                   self._smooth_len()))[:n_ring]
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
        rho = _host(self._autocorr_rho(self._put(padded), lag,
                                       det_smooth))[:n_ring]
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
                                  self.cfg,
                                  self._put(np.float32(self.freq_center)))
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
