"""Shared host wrapper for window-based burst demodulators (torch).

Counterpart of ``aero_tpu/models/burst_common.py``; read that module's
docstring for the detection design (an autocorrelation arm at the
preamble's coherence lag plus a power-envelope arm, each detection
anchoring a burst-extent gate whose complete runs become fixed-size
windows for the modulation's window demodulator).

The ring of recent audio lives on the demodulator's ``device``, zero past
its length, in a buffer it slides along as it is trimmed: a block appends
its samples there in one copy.  The detection runs on the device as two
graphed steps the demodulator holds (``utils/graphs.py``), the
counterparts of JAX's jits, over the ring zero-padded to a 16384 multiple
(one CUDA graph per bucket on a card): ``_autocorr_rho`` (``_rho_arm``:
the autocorrelation statistic and the count of long detection runs) and
``_envelope`` (``_power_arm``: the smoothed envelope, the noise floor's
update from its 25th percentile, and the count of strong power runs), on
two streams at once on a card.  The ring's length and where the
percentile interpolates come from the host (``_scan_plan``) when the
length changes; the noise floor stays on the device from block to block.
Each block reads back three numbers: the noise floor, which the host
keeps as a float, and the two counts.  With no run counted no candidate
exists, and ``process`` returns at once; otherwise the envelope, the
statistic and the ring come to the host, and JAX's host loop scans them,
unchanged.  Both paths make JAX's decisions bit for bit: the device
reproduces ``np.percentile``'s interpolation and compares in float32, as
numpy compares a float32 array with a Python float
(``tests/test_torch_burst.py`` holds them to a copy of the host-only
``process`` and to numpy).  The window function is a third graphed step,
one graph per configuration, its ``freq_center`` a 0-d input tensor, so
that ``set_center`` retunes a captured graph.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from aero_tpu_torch.device import resolve_device
from aero_tpu_torch.ops.fir import convolve_same
from aero_tpu_torch.utils.graphs import stateless
from aero_tpu_torch.utils.profiling import TRACER

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


# the slots of the detection arms' host inputs (``_scan_plan``)
_N_RING, _LO, _HI, _W, _UPPER, _NF = range(6)


def _scan_plan(n_ring: int, noise_floor: float) -> np.ndarray:
    """The detection arms' inputs from the host, one float64 vector: the
    ring's length; where ``np.percentile(env[:n_ring], 25.0)`` interpolates
    (numpy's linear method: the order statistics lo = floor((n - 1) / 4)
    and hi = lo + 1 clipped to n - 1, the weight t = (n - 1) / 4 - lo,
    which ``_lerp`` applies from the upper one, as t - 1, where t >= 0.5);
    and the noise floor before the block."""
    m = max(n_ring - 1, 0)
    lo, t = m // 4, (m % 4) / 4
    upper = t >= 0.5
    return np.array([n_ring, lo, min(lo + 1, m), t - 1 if upper else t,
                     upper, noise_floor])


def _q25(x, valid, plan):
    """``np.percentile(x[valid], 25.0)`` of a float32 x [N], ``valid`` the
    first n samples (0 for n = 0), bit for bit, ``plan`` that of
    ``_scan_plan(n, ...)``: NumPy 2 interpolates a float32 array's order
    statistics in float32.  Returns a float32 0-d tensor."""
    s = torch.sort(torch.where(valid, x, math.inf)).values
    ab = s.gather(0, plan[_LO:_HI + 1].to(torch.int64))
    base = ab.gather(0, plan[_UPPER:_UPPER + 1].to(torch.int64))
    q = base + (ab[1] - ab[0]) * plan[_W].to(torch.float32)
    return torch.where(valid[0], q, 0.0).reshape(())


def _long_runs(mask, min_len: int):
    """How many runs of True in the bool mask [N] are at least
    ``min_len`` >= 1 long: ``_bool_runs`` with that length filter, in
    fixed-shape ops (a capture refuses ``nonzero``'s host sync).  A run
    that starts at s is long iff mask[s:s + min_len] holds no False."""
    N = mask.shape[-1]
    if min_len > N:
        return torch.zeros((), dtype=torch.int64, device=mask.device)
    starts = mask > F.pad(mask[:-1], (1, 0))
    c = F.pad(torch.cumsum(mask, 0), (1, 0))        # c[i] = mask[:i].sum()
    full = (c[min_len:] - c[:N + 1 - min_len]) == min_len
    return (starts[:N + 1 - min_len] & full).sum()


def _above(x, threshold):
    """``x > threshold`` for a float32 x as numpy compares it with a Python
    float (NEP 50): in float32, the threshold (a Python float, or a
    float64 0-d tensor holding one) rounded to float32 first.  A float64
    comparison would differ where x is that rounding: float32(0.1) lies
    above 0.1."""
    if isinstance(threshold, torch.Tensor):
        return x > threshold.to(torch.float32)
    return x > float(np.float32(threshold))


def _power_arm(ring, plan, noise_floor, smooth: int, gate_ratio: float,
               min_run: int):
    """The power arm over the padded ring [N], its first ``plan[_N_RING]``
    samples the ring's: the smoothed envelope, the noise floor after this
    block from the one before (float64 0-d, as the host's Python float:
    ``max(q25, 1e-12)`` the first time, then ``0.9 nf + 0.1 min(q25,
    4 nf)``), and the count of strong runs (``env > gate_ratio * nf``, at
    least ``min_run`` long).  Returns {"env": [N], "stats": [nf, count]}."""
    from aero_tpu_torch.models.burst_msk import _envelope
    env = _envelope(ring, smooth)
    valid = torch.arange(env.shape[-1], device=env.device) < plan[_N_RING]
    q25 = _q25(env, valid, plan).to(torch.float64)
    nf = torch.where(noise_floor <= 0, torch.clamp(q25, min=1e-12),
                     torch.minimum(q25, noise_floor * 4) * 0.1
                     + noise_floor * 0.9)
    runs = _long_runs(_above(env, nf * gate_ratio) & valid, min_run)
    return {"env": env, "stats": torch.stack([nf, runs.to(torch.float64)])}


def _rho_arm(ring, plan, lag: int, smooth: int, threshold: float,
             min_run: int):
    """The autocorrelation arm over the padded ring [N]: the statistic and
    the count of detection runs (``rho > threshold``, at least
    ``min_run`` long) in its first ``plan[_N_RING]`` samples.  Returns
    {"rho": [N], "runs": [count]} (float64)."""
    rho = _autocorr_rho(ring, lag, smooth)
    valid = torch.arange(rho.shape[-1], device=rho.device) < plan[_N_RING]
    runs = _long_runs(_above(rho, threshold) & valid, min_run)
    return {"rho": rho, "runs": runs.to(torch.float64).reshape(1)}


# the ring's buffer holds this many of its buckets: the ring slides along
# it as it is trimmed, and moves back to the front once in a few blocks
_SPAN = 4


def _bucket(n: int) -> int:
    """The padded ring's length: a 16384 multiple, at least one."""
    return max(16384, -(-n // 16384) * 16384)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _bool_runs(mask: np.ndarray):
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)))


class BurstWindowDemodulator:
    def __init__(self, cfg, window_fn, rho_threshold: float = 0.35,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._ring = np.zeros(0, np.float32)
        self._noise_floor = 0.0
        self.rho_threshold = rho_threshold
        self.freq_center = float(cfg.freq_center)
        self._pins = {}                # dtype -> pinned staging buffer
        self._held = None              # (ring length, noise floor) of _plan
        # on a card: a second stream for the power arm, and the events
        # that order it after the ring's upload and before the readback
        self._side = self._fork = self._join = None
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            self._fork, self._join = torch.cuda.Event(), torch.cuda.Event()
        name = type(self).__name__
        self._envelope = stateless(_power_arm, f"{name} _envelope",
                                   self.device)
        self._autocorr_rho = stateless(_rho_arm, f"{name} _autocorr_rho",
                                       self.device)
        self._window_fn = stateless(window_fn, f"{name} {window_fn.__name__}",
                                    self.device)

    @property
    def steps(self) -> list:
        """The graphed steps: the two detection arms and the window
        function."""
        return [self._envelope, self._autocorr_rho, self._window_fn]

    @property
    def state(self):                   # runtime/decoder compatibility
        return None

    @property
    def _ring(self) -> np.ndarray:
        """The ring's samples, a host copy (what a checkpoint saves)."""
        return self._buf[self._off:self._off + self._n].to(
            "cpu", copy=True).numpy()

    @_ring.setter
    def _ring(self, ring):
        ring = np.asarray(ring, np.float32)
        self._n, self._off = len(ring), 0
        self._buf = torch.zeros(_SPAN * _bucket(self._n), dtype=torch.float32,
                                device=self.device)
        self._buf[:self._n].copy_(torch.from_numpy(ring))

    def set_center(self, freq_center: float):
        """Hunter retune hook (ref decode.cpp:182,211 retunes burst demods
        too): shifts the per-window coarse-CFO search center."""
        self.freq_center = float(max(100.0, freq_center))

    def _smooth_len(self) -> int:
        return 8 * getattr(self.cfg, "sps", 20)

    def _det_smooth(self) -> int:
        # integration floor in ABSOLUTE samples: at high symbol rates
        # (OQPSK 10500 @ 48k -> sps=4) 16*sps is only 64 samples, where
        # noise rho peaks at ~0.6 and false windows chop real bursts
        # (measured r3); 256 samples keeps noise max ~0.31 < threshold
        # while staying well under the shortest (96-bit) preamble
        return max(16 * getattr(self.cfg, "sps", 20), 256)

    def _put(self, a) -> torch.Tensor:
        """A host array, or a numpy scalar as a 0-d tensor, for the
        demodulator's steps, which copy it into their static inputs on
        its device."""
        return torch.from_numpy(np.ascontiguousarray(a).reshape(np.shape(a)))

    def _staged(self, a: np.ndarray) -> torch.Tensor:
        """A 1-D host array as a tensor to copy to the device without a
        host sync: on a card, in a pinned buffer the demodulator keeps per
        dtype, which the next block may overwrite, as every ``process``
        ends with a host sync."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(a))
        pin = self._pins.get(a.dtype)
        if pin is None or pin[1].size < a.size:
            t = torch.empty(a.size, dtype=torch.from_numpy(a[:0]).dtype,
                            pin_memory=True)
            pin = self._pins[a.dtype] = (t, t.numpy())
        pin[1][:a.size] = a
        return pin[0][:a.size]

    def _forked(self, main):
        """On a card, a context whose work runs on the demodulator's second
        stream after what ``main``, the current stream, had queued at the
        last ``self._fork.record(main)``, beside what it queued since."""
        if main is None:
            return contextlib.nullcontext()
        self._side.wait_event(self._fork)
        return torch.cuda.stream(self._side)

    def _joined(self, outputs: dict, main) -> dict:
        """``outputs`` of the second stream's work, for ``main``, which
        waits for that work."""
        if main is not None:
            self._join.record(self._side)
            main.wait_event(self._join)
            for t in outputs.values():
                t.record_stream(main)
        return outputs

    def process(self, samples: np.ndarray):
        """Append one block of audio to the ring and emit the bursts whose
        windows are complete (JAX's ``process``, the same outputs and the
        same ring and noise floor after each block)."""
        cfg = self.cfg
        sps = getattr(cfg, "sps", 20)
        samples = np.asarray(samples, np.float32)
        if TRACER.on:
            TRACER.count("burst.scans")
        # the detection runs over the ring zero-padded to its bucket: the
        # ring length changes after every consumed burst, and a graph per
        # distinct length would capture again on the decode path; the
        # coarse bucket keeps the steady-state shape set to a handful
        n0 = self._n
        n_ring = n0 + len(samples)
        n_pad = _bucket(n_ring)
        if self._off + n_pad > self._buf.shape[0]:
            # the ring has slid to the buffer's end: back to the front
            buf = torch.zeros(_SPAN * n_pad, dtype=torch.float32,
                              device=self.device)
            buf[:n0].copy_(self._buf[self._off:self._off + n0])
            self._buf, self._off = buf, 0
        ring = self._buf[self._off:self._off + n_pad]
        ring[n0:n_ring].copy_(self._staged(samples), non_blocking=True)
        self._n = n_ring
        # the plan goes up when the ring's length changes or the noise
        # floor is not the one the device holds (the first block, a
        # checkpoint); in the steady state neither
        if (n_ring, self._noise_floor) != self._held:
            self._plan = self._staged(_scan_plan(
                n_ring, self._noise_floor)).to(self.device, non_blocking=True)
            self._nf = self._plan[_NF]
        plan = self._plan
        det_smooth = self._det_smooth()
        # the two arms share nothing but the ring: on a card they run on
        # two streams at once, the power arm beside the rho arm
        main = None
        if self._side is not None:
            main = torch.cuda.current_stream(self.device)
            self._fork.record(main)
        corr = self._autocorr_rho(
            ring, plan, lag=max(1, int(round(2.0 * cfg.fs / cfg.fb))),
            smooth=det_smooth, threshold=float(self.rho_threshold),
            min_run=max(6 * sps, det_smooth // 2))
        with self._forked(main):
            power = self._envelope(ring, plan, self._nf,
                                   smooth=self._smooth_len(),
                                   gate_ratio=float(cfg.gate_ratio),
                                   min_run=2 * self._smooth_len())
        power = self._joined(power, main)
        self._noise_floor, n_strong, n_det = torch.cat(
            [power["stats"], corr["runs"]]).tolist()
        self._nf = power["stats"][0]
        self._held = (n_ring, self._noise_floor)
        outs, consumed = [], 0
        if n_strong or n_det:
            # a candidate exists: the host loop scans the statistics
            if TRACER.on:
                TRACER.count("burst.scans_host")
            outs, consumed = self._scan(self._ring,
                                        _host(power["env"][:n_ring]),
                                        _host(corr["rho"][:n_ring]))

        # retained tail must cover the WIDEST window a deferred run can
        # still become: the deferral in _scan waits on runs ending up to
        # max_gap + pad before the ring end, so a near-window-length
        # burst needs W + max_gap + 2*pad of history or its head is
        # trimmed before the window is ever emitted
        pad = self._smooth_len() // 2
        keep = cfg.window_len + 4 * self._smooth_len() + 2 * pad
        keep_from = max(consumed, n_ring - keep)
        if keep_from > 0:             # the buffer past the ring stays zero
            self._off += keep_from
            self._n = n_ring - keep_from
        if not outs:
            outs.append({
                "soft_bits": np.zeros(0, np.int16),
                "burst": False, "signal": False,
                "freq": self.freq_center, "tone_quality": 0.0,
            })
        return outs

    def _scan(self, ring, env, rho):
        """JAX's candidate loop over the ring and its statistics on the
        host: the windows it emits and the samples they consumed."""
        cfg = self.cfg
        sps = getattr(cfg, "sps", 20)
        nf = self._noise_floor
        outs = []

        # ---- candidate detections ----
        det_smooth = self._det_smooth()
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
            win = ring[w0: w0 + W]
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
            consumed = max(consumed, min(ge + pad, len(ring)))

        return outs, consumed
