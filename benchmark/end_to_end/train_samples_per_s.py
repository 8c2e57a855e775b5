"""Samples trained per second of the window: N x the window's epochs over
its seconds, from the measured call's request for epoch 1's plan to the
end of its Q pass (host clock, synchronised at both ends)."""


def read(run):
    return run.samples / run.window_s if run.window_s > 0 else None
