"""The median, over every request of the window, of the host milliseconds
from the call to the logits on the host."""
import statistics


def read(window):
    return 1e3 * statistics.median(window.latencies_s)
