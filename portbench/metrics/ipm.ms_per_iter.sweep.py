"""Milliseconds of the batched solve (the harness's synchronized host
timer around it) per factorization launched (the program's launch
count of factor_se: one per batched solver iteration)."""


def read(run):
    n = run.launches.get("factor_se", 0)
    if run.kind != "sweep" or not n:
        return None
    return 1e3 * run.seconds["solve"] / n
