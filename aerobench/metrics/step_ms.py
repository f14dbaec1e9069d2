"""Device step: ms of device time per block of the graphed step
(`FusedStation._run_block`), CUDA events around each replay, mean over
the window's blocks."""


def read(trace, run):
    v = trace.step_ms
    return sum(v) / len(v) if v else None
