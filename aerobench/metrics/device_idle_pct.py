"""Device: the share of the profiled stretch of the window in which
no operation ran on the card (1 - union of device activity / wall)."""


def read(trace, run):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
