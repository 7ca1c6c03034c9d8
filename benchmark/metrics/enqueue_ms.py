"""Host milliseconds of an ``IntModel`` call, from the call to its return,
not synchronized: the mean over the calls of the window (untraced)."""


def read(trace):
    e = trace.window.enqueue_s
    if not e:
        return None
    return 1e3 * sum(e) / len(e)
