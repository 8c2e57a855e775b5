"""The whole step's share of the chip's peak over the traced log period:
the period's model FLOP (benchmark/work.py step_model_flops: forward xv
and raw, backward dq, dP and dV) over the period's wall time, against the
dense TF32 peak, in percent."""
from benchmark import work


def read(run):
    begin, end = run.period
    if not run.events or end <= begin:
        return None
    flop = sum(work.step_model_flops(rows, run.M, run.D, run.ks)
               for rows, _ in run.period_steps)
    return 100.0 * flop / ((end - begin) * 1e-6) / work.PEAKS["tf32_flops"]
