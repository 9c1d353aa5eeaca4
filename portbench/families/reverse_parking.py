"""Reverse parking: the base problem of a configuration, built by the
program's own builder (``obca_torch.reverse_parking_spec``)."""


def base_spec(cfg, device, dtype):
    """(problem module, base problem) of the configuration."""
    from obca_torch import nlp, reverse_parking_spec

    return nlp, reverse_parking_spec(N=cfg["N"], Ts=cfg["Ts"],
                                     d_min=cfg["d_min"], dtype=dtype,
                                     device=device)
