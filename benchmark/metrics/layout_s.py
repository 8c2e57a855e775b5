"""The measured call's layout: the rows' pre-shuffle on the host and their
upload (launch_training's phase_seconds["layout"], host clock after a
synchronise)."""


def read(run):
    return run.phase.get("layout")
