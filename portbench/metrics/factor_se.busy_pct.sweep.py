"""Share of the traced window's device busy time spent in the
factor_se kernels: their device time (by the trace's operation names)
over the union of every device operation's intervals."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    device_s = sum(s for name, s in run.trace["by_name"].items()
                   if "factor_se_kernel" in name)
    if device_s <= 0:
        return None
    return 100.0 * device_s / run.trace["busy_s"]
