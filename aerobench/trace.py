"""What a traced run reads: the probe's spans over the window, the CUDA
event times of the steps, and ``torch.profiler`` over a short steady
stretch of the window, reduced to the device's busy time (the union of
its operations), the device time of each operation by name, the longest
idle gaps by what the host was doing, and the Viterbi launches of the
stretch.  The per-layer metrics (``metrics/<name>.py``) read a ``Trace``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    kind: str = ""
    spans: dict = field(default_factory=dict)     # name -> [s per block]
    step_ms: list = field(default_factory=list)
    queue_s: list = field(default_factory=list)   # paced: due -> drain
    busy_s: float = 0.0
    window_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)  # device op -> seconds
    launches: list = field(default_factory=list)  # [(rows, steps)]
    idle_gaps: list = field(default_factory=list)


class Stretch:
    """``torch.profiler`` over part of the window: ``start()``, ``stop()``
    then ``reduce(trace, launches)``; ``due(now)`` says when to start or
    stop for a stretch of ``seconds`` from ``at``."""

    def __init__(self, cuda: bool, at: float = 0.0, seconds: float = 0.0):
        self.at, self.seconds = at, seconds
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.cuda = cuda
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def tick(self, now: float) -> None:
        """Start the profiler at ``at``, stop it ``seconds`` later."""
        if self.t0 is None:
            if now >= self.at:
                self.start()
        elif self.t1 is None and now >= self.t0 + self.seconds:
            self.stop()

    def start(self) -> None:
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, tr: Trace, launches) -> None:
        tr.window_s = self.t1 - self.t0
        tr.launches = [(r, s) for t, r, s in launches
                       if self.t0 <= t <= self.t1]
        evs = self.prof.events()
        # device operations; the record_function ranges' device-side
        # annotations are the host's spans, not work
        dev = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("bench.")]
        by_name = defaultdict(float)
        spans = []
        for e in dev:
            by_name[e.name] += e.time_range.elapsed_us() / 1e6
            spans.append((e.time_range.start, e.time_range.end))
        tr.kernel_s = dict(by_name)
        busy, gaps = _union(spans)
        tr.busy_s = busy / 1e6
        host = [(e.time_range.start, e.time_range.end, e.name[6:])
                for e in evs if e.name.startswith("bench.")]
        label = defaultdict(float)
        # the gaps between a replay's kernels last a few microseconds;
        # label the ones the host leaves
        for g0, g1 in (g for g in gaps if g[1] - g[0] >= 20.0):
            mid = 0.5 * (g0 + g1)
            cover = [(h1 - h0, n) for h0, h1, n in host if h0 <= mid <= h1]
            label[min(cover)[1] if cover else "other"] += (g1 - g0) / 1e6
        tr.idle_gaps = sorted(label.items(), key=lambda kv: -kv[1])[:10]


def warm_profiler(cuda: bool) -> None:
    """Start and stop the profiler once, so that its start-up falls in
    the set-up and not in the window's stretch."""
    s = Stretch(cuda)
    s.start()
    s.stop()


def _union(intervals) -> tuple:
    """(busy microseconds, idle gaps between busy runs) of intervals."""
    busy, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def device_ops(tr: Trace) -> list:
    """The ten device operations that took most time: [[name, s]]."""
    top = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return [[k, v] for k, v in top]
