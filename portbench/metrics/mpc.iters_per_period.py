"""Mean solver iterations of a control period's re-solve, over every
period in the window (MpcResult.iters)."""


def read(run):
    n = sum(p["iters"].size for p in run.periods)
    if not n:
        return None
    return float(sum(p["iters"].sum() for p in run.periods)) / n
