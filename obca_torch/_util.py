"""Small tensor helpers shared across the package (device choice and
the jnp functions whose exact semantics the port reproduces)."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.
    There is no silent CPU fallback: asking for CUDA without a GPU
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "obca_torch: CUDA requested but no GPU is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def linspace(start, stop, num: int, dtype, device):
    """``jnp.linspace`` (endpoint=True) with its exact arithmetic —
    start*(1 - i/div) + stop*(i/div), then the exact endpoint — along a
    new last axis; tensor start/stop broadcast over leading axes."""
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = start[..., None] * (1.0 - step) + stop[..., None] * step
    end = torch.broadcast_to(stop, out.shape[:-1])[..., None]
    return torch.cat([out, end], dim=-1)


def interp(x, xp, fp):
    """Batched ``jnp.interp``: x [B, K], xp/fp [B, P] (xp sorted).
    Same index rule (searchsorted right, clipped to [1, P-1]), the same
    zero-width guard and the same constant extension at both ends."""
    P = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = i.clamp(1, P - 1)
    xp0 = torch.gather(xp, -1, i - 1)
    xp1 = torch.gather(xp, -1, i)
    fp0 = torch.gather(fp, -1, i - 1)
    fp1 = torch.gather(fp, -1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp0,
                    fp0 + (delta / torch.where(dx0, torch.ones_like(dx),
                                               dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    f = torch.where(x > xp[..., -1:], fp[..., -1:], f)
    return f


def one_hot(idx, n: int, dtype):
    return torch.nn.functional.one_hot(idx, n).to(dtype)
