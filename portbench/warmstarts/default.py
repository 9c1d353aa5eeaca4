"""The problem family's default initial point (``ipm.default_init``)."""


def warm_start(prog, specs, dtype):
    from obca_torch.solver import ipm

    return ipm.default_init(specs, dtype, prog.prob)
