"""Seconds from the process's start to the first timed call: imports, the
kernels' libraries (built in the run that compiles), the bake, the
artifact's round trip, the program's packing and the warm-up."""


def read(window):
    return window.setup_s
