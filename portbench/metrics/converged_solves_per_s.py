"""Converged lanes of every sweep request in the window over the
window's seconds (host clock)."""


def read(run):
    if run.kind != "sweep" or not run.requests:
        return None
    return sum(r["converged"] for r in run.requests) / run.window_s
