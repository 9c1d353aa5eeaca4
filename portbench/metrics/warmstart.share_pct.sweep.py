"""Share of the window spent in the warm-start stage (plan field and
per-lane warm starts), by the harness's synchronized host timer around
those calls."""


def read(run):
    if run.kind != "sweep" or "warmstart" not in run.seconds:
        return None
    return 100.0 * run.seconds["warmstart"] / run.window_s
