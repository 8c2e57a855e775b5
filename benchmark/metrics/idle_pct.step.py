"""Share of the traced log period in which the device runs no kernel, copy
or memset while the host is inside a step's spans (na.batch, na.forward,
na.backward, na.adam, na.clamp), in percent."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, spans.STEP)
