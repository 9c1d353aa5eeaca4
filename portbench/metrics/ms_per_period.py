"""The window's milliseconds over the control periods it completed
(host clock); each maneuver's warm start and initial plan count in the
time, as a vehicle pays them."""


def read(run):
    n = sum(p["status"].size for p in run.periods)
    if run.kind != "mpc" or not n:
        return None
    return run.window_s * 1e3 / n
