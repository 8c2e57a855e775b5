"""The measured call's Q pass, inside the window: the full-data forward
over the resident rows, Q to host memory and its rows' un-shuffle
(launch_training's phase_seconds["q_pass"], host clock after a
synchronise)."""


def read(run):
    return run.phase.get("q_pass")
