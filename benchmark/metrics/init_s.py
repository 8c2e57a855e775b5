"""The warm-up call's init: the parameters to the device and the process's
first torch.optim.Adam (launch_training's phase_seconds["init"])."""


def read(run):
    return run.warm_phase.get("init")
