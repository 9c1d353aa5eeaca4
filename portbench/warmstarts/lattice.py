"""One plan field of the base problem, then a lattice warm start a lane
(``lattice.plan_field``, ``geometric.lattice_warm_start``)."""


def warm_start(prog, specs, dtype):
    from obca_torch.warmstart import geometric, lattice

    lcfg = lattice.LatticeConfig.for_spec(prog.base)
    field = lattice.plan_field(prog.base, lcfg)
    return geometric.lattice_warm_start(specs, dtype=dtype, cfg=lcfg,
                                        field=field)
