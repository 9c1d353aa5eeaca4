"""Mean solver iterations of a lane (pass 1 plus rescue rounds;
SolveResult.iters) over every lane of the window."""


def read(run):
    n = sum(r["iters"].size for r in run.requests)
    if run.kind != "sweep" or not n:
        return None
    return float(sum(r["iters"].sum() for r in run.requests)) / n
