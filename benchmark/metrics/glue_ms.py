"""Device milliseconds a forward of every device item that is not one of
the program's own kernels (benchmark/kernels/port.json): torch's
kernels, cuBLAS, copies."""


def read(trace):
    if not trace.forwards or not trace.items:
        return None
    total = sum(e - s for _, s, e in trace.items)
    return 1e3 * (total - trace.time_of("port")) / trace.forwards
