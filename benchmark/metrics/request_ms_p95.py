"""The 95th percentile, over every request of the window (untraced), of
the host milliseconds from the call to the logits on the host.  Per
layer: on a shared host its spread from run to run is wider than an
end-to-end bound can hold."""
import numpy as np


def read(trace):
    lat = trace.window.latencies_s
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
