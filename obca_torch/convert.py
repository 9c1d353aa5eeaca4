"""Build the port's spec and config objects from plain numpy trees.

``spec_from_numpy`` takes a dict with one entry per ``ProblemSpec``
field (arrays for tensor fields, Python values for static ones;
``obstacles`` a dict of ``Obstacles`` fields), with or without a
leading batch axis.  ``config_from_numpy`` does the same for
``SolverConfig``, with dtypes given as anything ``numpy.dtype`` takes.
Nothing here depends on where the tree came from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from obca_torch._util import resolve_device
from obca_torch.spec import Obstacles, ProblemSpec, SolverConfig

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)}


def _build(cls, tree, dev, dtype):
    kw = {}
    for name, f in _fields(cls).items():
        if name not in tree:
            continue
        v = tree[name]
        if f.type == "torch.Tensor":
            kw[name] = torch.tensor(np.asarray(v), dtype=dtype, device=dev)
        elif f.type == "Obstacles":
            kw[name] = _build(Obstacles, v, dev, dtype)
        else:
            kw[name] = type(f.default)(v) if f.default is not None else v
    return cls(**kw)


def spec_from_numpy(tree: dict, device="cuda",
                    dtype=torch.float64) -> ProblemSpec:
    """A ProblemSpec (or stacked batch) from a dict of numpy leaves."""
    return _build(ProblemSpec, tree, resolve_device(device), dtype)


def torch_dtype(d):
    """numpy dtype-like (or None) -> torch dtype (or None)."""
    return None if d is None else _TORCH_DTYPES[np.dtype(d)]


def config_from_numpy(tree: dict) -> SolverConfig:
    """A SolverConfig from a dict of numpy scalars / Python values."""
    kw = {}
    for name, f in _fields(SolverConfig).items():
        if name not in tree:
            continue
        v = tree[name]
        if f.type == "torch.Tensor":
            kw[name] = torch.as_tensor(float(np.asarray(v)),
                                       dtype=torch.float64)
        elif name in ("dtype", "residual_dtype", "factor_dtype"):
            kw[name] = torch_dtype(v)
        else:
            kw[name] = type(f.default)(v)
    return SolverConfig(**kw)
