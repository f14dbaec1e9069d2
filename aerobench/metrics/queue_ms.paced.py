"""In-flight queue: ms from a block's due time to the start of its
drain, host clock, mean over the paced window's blocks."""


def read(trace, run):
    v = trace.queue_s
    return 1e3 * sum(v) / len(v) if v else None
