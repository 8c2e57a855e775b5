"""The decoder plane: raw, dq and dP of every head, the BCE gradient and,
on logged steps, its logarithms (the port's PlaneBCE forward and
backward).

The share of the roofline over the traced log period: the sum of each
step's bound (benchmark/work.py, the layer "plane") over the device time
of the kernels launched inside the host ops PlaneBCE, PlaneBCEBackward, in percent."""
from benchmark import trace, work

OPS = ('PlaneBCE', 'PlaneBCEBackward')


def read(run):
    begin, end = run.period
    if not run.events or end <= begin:
        return None
    us = trace.kernel_us_under(run.events, begin, end, OPS)
    if not us:
        return None
    bound_s = work.period_bound(run.period_steps, run.M, run.D, run.ks,
                                   "plane")
    return 100.0 * bound_s / (us * 1e-6)
