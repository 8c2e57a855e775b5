"""Seconds from the process's start to the window's opening: CUDA start,
the kernels' load (their build in a fresh checkout), the panel, the
weights, the warm-up call and the measured call's layout, init and epoch
0."""


def read(run):
    return run.setup_s
