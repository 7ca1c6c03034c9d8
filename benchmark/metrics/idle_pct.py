"""Share of a call's time in which no device item ran: the traced
stretch's busy seconds a forward (the union of its device items), against
the seconds a call took in the window, which is untraced (the profiler
slows the host, so the stretch's own host seconds would count its cost as
idle)."""


def read(trace):
    w = trace.window
    if not trace.forwards or not trace.items or not w.calls:
        return None
    busy = trace.busy_s() / trace.forwards
    return 100.0 * (1.0 - busy / (w.seconds / w.calls))
