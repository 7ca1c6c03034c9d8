"""K6's share of its roofline: the bound of the encoder's work for the
real images of the traced forwards (each forward's images as one launch
would take them: benchmark/harness/counts.py), over K6's device time
(benchmark/kernels/k6.json)."""
from harness import counts


def read(trace):
    t = trace.time_of("k6")
    if t <= 0:
        return None
    need = sum(counts.k6_bound_s(trace.spec, n)
               for n in trace.images_per_forward)
    return 100.0 * need / t
