"""Reverse parking in a cluttered lot: the base problem of a
configuration that states its own obstacles, built as
``obca_torch.randomized_reverse_parking_specs(..., vary_topology=True)``
builds one layout: the reverse-parking problem padded to (max_obs,
max_faces), its obstacles replaced by the configuration's
(``obca_torch.spec.obstacles_from_vertices``)."""


def base_spec(cfg, device, dtype):
    """(problem module, base problem) of the configuration."""
    import dataclasses

    from obca_torch import nlp, reverse_parking_spec
    from obca_torch.spec import obstacles_from_vertices

    M, V = cfg["max_obs"], cfg["max_faces"]
    base = reverse_parking_spec(N=cfg["N"], Ts=cfg["Ts"], d_min=cfg["d_min"],
                                max_obs=M, max_faces=V, dtype=dtype,
                                device=device)
    obs = obstacles_from_vertices(cfg["obstacles"], max_obs=M, max_faces=V,
                                  dtype=dtype, device=device)
    return nlp, dataclasses.replace(base, obstacles=obs)
