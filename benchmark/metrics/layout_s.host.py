"""The measured call's layout up to the rows' upload: the pre-shuffle, the
missing scan, the row permute and the padding to whole batches
(launch_training's phase_seconds["layout.host"], host clock after a
synchronise)."""


def read(run):
    return run.phase.get("layout.host")
