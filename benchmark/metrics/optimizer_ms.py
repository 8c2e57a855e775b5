"""The optimizer update: device milliseconds a step of the kernels launched
inside the spans na.adam (Adam's step) and na.clamp (P clamped to [0, 1])
over the traced log period."""
from benchmark import spans


def read(run):
    return spans.kernel_ms_per_step(run, spans.OPTIMIZER)
