"""The forward projection Xp = X @ V (the port's XV forward).

The share of the roofline over the traced log period: the sum of each
step's bound (benchmark/work.py, the layer "xv") over the device time
of the kernels launched inside the host ops XV, in percent."""
from benchmark import trace, work

OPS = ('XV',)


def read(run):
    begin, end = run.period
    if not run.events or end <= begin:
        return None
    us = trace.kernel_us_under(run.events, begin, end, OPS)
    if not us:
        return None
    bound_s = work.period_bound(run.period_steps, run.M, run.D, run.ks,
                                   "xv")
    return 100.0 * bound_s / (us * 1e-6)
