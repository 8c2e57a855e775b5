"""The measured call's upload of its rows to the device, the rest of its
layout (launch_training's phase_seconds["layout.upload"], host clock after
a synchronise)."""


def read(run):
    return run.phase.get("layout.upload")
