"""Kernel: the Viterbi kernel's share of its roofline over the profiled
stretch: the least time its launches' work could take on the card
(`roofline.py`: int32 operations over the integer peak, or bytes over
the memory bandwidth, whichever is larger) over the kernel's device
time by name.  The work is counted from each launch's real frames and
trellis steps, not its padded rows."""

from aerobench import roofline


def read(trace, run):
    secs = sum(v for k, v in trace.kernel_s.items()
               if roofline.VITERBI_KERNEL in k)
    ops, nbytes = roofline.viterbi_work(trace.launches)
    return roofline.share(ops, nbytes, secs, trace.kind)
