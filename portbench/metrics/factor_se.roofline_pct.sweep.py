"""factor_se's share of its roofline over the window: the least time
the card could take for every factor_se call at its own shape (bytes at
the published memory rate or float32 operations at the published peak,
``yardstick.kernel_costs``), over the device time the trace gives the
factor_se kernels."""

from portbench import yardstick


def read(run):
    if run.trace is None or not run.factor_calls:
        return None
    device_s = sum(s for name, s in run.trace["by_name"].items()
                   if "factor_se_kernel" in name)
    if device_s <= 0:
        return None
    bound = sum(yardstick.bound_s(*yardstick.kernel_costs(*shape)[
        "factor_se"]) for shape in run.factor_calls)
    return 100.0 * bound / device_s
