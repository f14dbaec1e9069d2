"""Batched P decode: ms per block of `BatchPChannelFramerBank._decode`
(graphed, the Viterbi kernel inside), host clock to a synchronize, mean
over the window."""


def read(trace, run):
    v = trace.spans.get("decode")
    return 1e3 * sum(v) / len(v) if v else None
