"""Profiling helpers around torch.profiler (counterpart of
``aero_tpu/utils/profiling.py``).

``RateMeter`` is the reference's as it is.  ``trace_to`` records the CPU
and, where a card is present, the CUDA activity of the enclosed block and
writes a Chrome trace.  The JAX package's ``enable_compile_cache`` and
the CLIs' ``--compile-cache`` have no counterpart: torch has no XLA
compile cache, and the kernel's build directory ``build/aero_tpu_torch/``
is the port's cache.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a torch.profiler trace of the enclosed block:

        with trace_to("/tmp/aero-trace"):
            station.process(block)

    The trace lands in ``logdir/trace.json`` (open it in Perfetto or
    chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RateMeter:
    """Samples/s + realtime-factor meter for streaming loops."""

    def __init__(self, sample_rate: float):
        self.sample_rate = sample_rate
        self.samples = 0
        self.t0 = time.perf_counter()

    def update(self, n_samples: int):
        self.samples += n_samples

    @property
    def samples_per_s(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.samples / dt if dt > 0 else 0.0

    @property
    def realtime_factor(self) -> float:
        return self.samples_per_s / self.sample_rate
