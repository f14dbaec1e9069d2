"""The benchmark's own spans and records around the calls into each layer
of the fused station; the program itself is not changed.

Always on (a host copy of each drained buffer is made anyway, and the
rest is bookkeeping): which block each drain serves and when it starts,
the packed rows of the blocks the comparison reads, the R/T packets the
framers return, and the batched decodes' inputs and outputs during the
drains the comparison reads.

Traced runs only (``trace=True``): the host time of each block's
quantize, CUDA events around each block's graphed step, and the drain
cut by stage as ``drain_split`` in ``chip_smoke.py`` cuts it (each
graphed drain step timed to a synchronize; the framers are the rest),
plus a ``torch.profiler.record_function`` range per stage, which the
trace reduction uses to say what the host was doing in each idle gap of
the device, and the real rows and trellis steps of every Viterbi launch.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch


class _Timed:
    """A drain step, timed to a synchronize under ``stage``; attributes
    read through to the step."""

    def __init__(self, probe, step, stage):
        self.probe, self.step, self.stage = probe, step, stage

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args, **kw):
        p = self.probe
        if not p.trace:
            return self.step(*args, **kw)
        with torch.profiler.record_function(f"bench.{self.stage}"):
            t0 = time.perf_counter()
            out = self.step(*args, **kw)
            p.sync()
            p.stage_s[self.stage] += time.perf_counter() - t0
        return out


class _Decode(_Timed):
    """The batched P decode: timed, its launches counted, and, while the
    drain of a compared block runs, each real row kept with its VFO, the
    stream soft bytes its frame was cut from, its history prefix and the
    decode's output."""

    def __init__(self, probe, step, stage, bank):
        super().__init__(probe, step, stage)
        self.bank = bank

    def __call__(self, soft, prefixes, **kw):
        p = self.probe
        # the rows in the bank's order: every framer's pending frames
        pend = ([(t, pre) for t, f in self.bank.framers.items()
                 for pre in f._pending] if p.keep_decodes else [])
        out = super().__call__(soft, prefixes, **kw)
        if p.trace:
            s = soft.cpu().numpy()
            p.launch(int(np.sum(np.any(s != 128, axis=1))),
                     (prefixes.shape[1] + s.shape[1] + 48) // 2)
        if pend:
            n = len(pend)
            p.decodes.append((p.block, kw["rate"], [t for t, _ in pend],
                              [np.asarray(pre["raw"], np.float32).copy()
                               for _, pre in pend],
                              np.asarray(prefixes.cpu().numpy())[:n].copy(),
                              out["info_bits"].cpu().numpy()[:n],
                              out["su_ok"].cpu().numpy()[:n]))
        return out


class Probe:
    def __init__(self, st, trace: bool, keep_blocks=()):
        self.st, self.trace = st, trace
        self.keep = set(keep_blocks)
        self.rows = {}                  # block -> packed row (numpy)
        self.block = -1                 # the block being drained
        self.drained = 0
        self.drain_start = {}           # block -> perf_counter
        self.packets = []               # (block, topic, kind, infofield)
        self.decodes = []
        self.keep_decodes = False
        self.spans = defaultdict(list)  # name -> seconds per block
        self.stage_s = defaultdict(float)
        self.launches = []              # (perf_counter, B, T)
        self.events = []                # (CUDA event 0, event 1) per block
        self.cuda = st.device.type == "cuda"
        self._wrap()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def launch(self, rows: int, steps: int) -> None:
        if self.trace:
            self.launches.append((time.perf_counter(), rows, steps))

    def _wrap(self):
        st = self.st
        for bank in st._batch_banks.values():
            bank._decode = _Decode(self, bank._decode, "decode", bank)
        for dm in st.burst_demods.values():
            for a in ("_envelope", "_autocorr_rho", "_window_fn"):
                setattr(dm, a, _Timed(self, getattr(dm, a), "burst"))
        for topic, fr in st.rt_framers.items():
            feed, dec = fr.feed, fr.decoder

            def rt_feed(soft16, _feed=feed, _t=topic):
                evs = _feed(soft16)
                for ev in evs:
                    self.packets.append((self.block, _t, ev.kind,
                                         bytes(ev.infofield)))
                return evs

            def rt_decode(soft, _dec=dec):
                self.launch(1, len(soft) // 2)
                return _dec(soft)
            fr.feed, fr.decoder = rt_feed, rt_decode
        drain, quantize, run_block = st._drain, st.quantize, st._run_block

        def timed_drain(packed):
            b = self.drained
            self.block = b
            self.drain_start[b] = time.perf_counter()
            self.keep_decodes = b in self.keep
            if self.trace:
                for k in self.stage_s:
                    self.stage_s[k] = 0.0
                with torch.profiler.record_function("bench.d2h"):
                    t0 = time.perf_counter()
                    host = packed.cpu()
                    t1 = time.perf_counter()
                with torch.profiler.record_function("bench.framers"):
                    drain(host)
                t2 = time.perf_counter()
                self.spans["d2h"].append(t1 - t0)
                self.spans["drain"].append(t2 - t0)
                self.spans["decode"].append(self.stage_s["decode"])
                self.spans["burst"].append(self.stage_s["burst"])
                self.spans["framers"].append(
                    (t2 - t1) - self.stage_s["decode"] - self.stage_s["burst"])
            else:
                host = packed.cpu()
                drain(host)
            if b in self.keep:
                self.rows[b] = host.numpy()[0].copy()
            self.keep_decodes = False
            self.drained += 1

        def timed_quantize(iq):
            if not self.trace:
                return quantize(iq)
            with torch.profiler.record_function("bench.quantize"):
                t0 = time.perf_counter()
                q = quantize(iq)
                self.spans["quantize"].append(time.perf_counter() - t0)
            return q

        def timed_run_block(iq2, scale, out):
            if not self.trace:
                return run_block(iq2, scale, out)
            if not self.cuda:
                t0 = time.perf_counter()
                run_block(iq2, scale, out)
                self.spans["step"].append(time.perf_counter() - t0)
                return
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function("bench.step"):
                e0.record()
                run_block(iq2, scale, out)
                e1.record()
            self.events.append((e0, e1))

        st._drain, st.quantize, st._run_block = (timed_drain, timed_quantize,
                                                 timed_run_block)

    def step_ms(self) -> list:
        """Device time of each block's step: CUDA events on a card, the
        host clock around the eager step on the CPU."""
        if not self.cuda:
            return [1e3 * s for s in self.spans["step"]]
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events]
