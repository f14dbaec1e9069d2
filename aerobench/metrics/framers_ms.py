"""Framers: ms per block of the drain less its timed device calls
(batched decode, burst statistics and windows) and its D2H: UW search,
bookkeeping, C channels' Viterbi, R/T framing, SU dispatch, ACARS and
output; host clock, mean over the window."""


def read(trace, run):
    v = trace.spans.get("framers")
    return 1e3 * sum(v) / len(v) if v else None
