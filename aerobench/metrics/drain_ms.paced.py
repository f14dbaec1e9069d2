"""Drain: ms per block of `FusedStation._drain` (D2H, batched decode,
burst watchers, framers, output), host clock, mean over the window."""


def read(trace, run):
    v = trace.spans.get("drain")
    return 1e3 * sum(v) / len(v) if v else None
