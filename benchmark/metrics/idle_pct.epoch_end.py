"""Share of the traced log period in which the device runs no kernel, copy
or memset while the host is at an epoch's boundary (the spans na.plan and
na.epoch_end), in percent."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, spans.EPOCH_END)
