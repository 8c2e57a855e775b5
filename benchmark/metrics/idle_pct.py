"""Share of the traced log period in which the device runs no kernel, copy
or memset, in percent."""
from benchmark import trace


def read(run):
    begin, end = run.period
    if not run.events or end <= begin:
        return None
    busy = trace.busy_us(run.events, begin, end)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (end - begin))
