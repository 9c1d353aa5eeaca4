"""Share of the traced window in which no operation ran on the device:
100 minus the union of the device operations' intervals over the
window."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
