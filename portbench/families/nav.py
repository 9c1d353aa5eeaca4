"""Point-mass navigation: the base problem of a configuration, built by
the program's own builder (``obca_torch.nav.nav_spec``)."""


def base_spec(cfg, device, dtype):
    """(problem module, base problem) of the configuration."""
    from obca_torch import nav

    return nav, nav.nav_spec(
        x0=cfg["x0"], xF=cfg["xF"], N=cfg["N"], Ts=cfg["Ts"],
        vertex_lists=cfg["obstacles"], d_min=cfg["d_min"],
        max_obs=cfg["max_obs"], max_faces=cfg["max_faces"],
        dtype=dtype, device=device)
