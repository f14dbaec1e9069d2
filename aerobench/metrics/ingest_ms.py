"""Host ingest: ms per block of `FusedStation.quantize` (int4, the
native ingest), host clock, mean over the window's blocks."""


def read(trace, run):
    v = trace.spans.get("quantize")
    return 1e3 * sum(v) / len(v) if v else None
