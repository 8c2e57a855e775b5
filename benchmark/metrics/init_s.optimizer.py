"""The warm-up call's torch.optim.Adam construction, the process's first
(launch_training's phase_seconds["init.optimizer"], host clock after a
synchronise)."""


def read(run):
    return run.warm_phase.get("init.optimizer")
