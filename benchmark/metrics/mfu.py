"""The whole forward's share of the card's int8 peak: the integer
operations of the images of the window (benchmark/harness/counts.py,
forward_ops), over the window's seconds, over 1,979 T op/s.  The window
is untraced: the profiler's cost is not in it."""
from harness import counts


def read(trace):
    w = trace.window
    if not w.images or not w.seconds:
        return None
    ops = counts.forward_ops(trace.spec, w.images)
    return 100.0 * ops / w.seconds / counts.PEAK_INT8_OPS
