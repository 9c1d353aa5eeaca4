"""Share of the window's control periods whose re-solve ran to the
iteration cap (MpcResult.iters at the traffic's resolve_max_iter)."""


def read(run):
    n = sum(p["iters"].size for p in run.periods)
    if not n:
        return None
    cap = run.mix["resolve_max_iter"]
    return 100.0 * sum(int((p["iters"] >= cap).sum())
                       for p in run.periods) / n
