"""Milliseconds of the window per factorization launched (the
program's launch count of factor_se: one per solver iteration)."""


def read(run):
    n = run.launches.get("factor_se", 0)
    if run.kind != "mpc" or not n:
        return None
    return 1e3 * run.window_s / n
