"""Burst watchers: ms per block of the burst demodulators' detection
statistics and window demods (graphed), host clock to a synchronize,
mean over the window."""


def read(trace, run):
    v = trace.spans.get("burst")
    return 1e3 * sum(v) / len(v) if v else None
