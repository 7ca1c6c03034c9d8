"""K2's share of its roofline: the summed bound of every integer MLP call
of the traced forwards (fc1, the GELU and fc2 at their rows:
benchmark/harness/counts.py), over K2's device time
(benchmark/kernels/k2.json)."""
from harness import counts


def read(trace):
    t = trace.time_of("k2")
    if t <= 0:
        return None
    need = sum(counts.k2_bound_s(trace.spec, n)
               for n in trace.images_per_forward)
    return 100.0 * need / t
