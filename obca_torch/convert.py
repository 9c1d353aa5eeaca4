"""Build the port's spec and config objects from plain numpy trees.

``spec_from_numpy`` takes a dict with one entry per ``ProblemSpec``
field (arrays for tensor fields, Python values for static ones;
``obstacles`` a dict of ``Obstacles`` fields), with or without a
leading batch axis; ``specs_from_numpy`` stacks a list of such dicts
into one batch; ``nav_spec_from_numpy`` does the same for a
``nav.NavSpec`` and ``dual_state_from_numpy`` for an ``ipm.DualState``.
``to_numpy_tree`` goes the other way, from any spec-like dataclass
whose array leaves numpy can read.
``config_from_numpy`` builds a ``SolverConfig``, with dtypes given as
anything ``numpy.dtype`` takes.  Nothing here depends on where the tree
came from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from obca_torch._util import resolve_device
from obca_torch.nav import NavSpec
from obca_torch.solver.ipm import DualState
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


def to_numpy_tree(obj) -> dict:
    """A spec-like dataclass as a dict of numpy leaves (nested
    dataclasses as dicts, tensors on any device copied to the host,
    other array leaves through ``numpy.asarray``, static fields as
    they are)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy_tree(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif hasattr(v, "__array__"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _stack_trees(trees):
    first = trees[0]
    return {k: (_stack_trees([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([np.asarray(t[k]) for t in trees])
                if isinstance(v, np.ndarray) else v)
            for k, v in first.items()}


def specs_from_numpy(trees: list, device="cuda",
                     dtype=torch.float64) -> ProblemSpec:
    """One batched ProblemSpec from a list of single-instance numpy
    trees (as :func:`to_numpy_tree` gives them), stacked in order."""
    return spec_from_numpy(_stack_trees(trees), device, dtype)


def nav_spec_from_numpy(tree: dict, device="cuda",
                        dtype=torch.float64) -> NavSpec:
    """A navigation NavSpec (or stacked batch) from a dict of numpy
    leaves."""
    return _build(NavSpec, tree, resolve_device(device), dtype)


def dual_state_from_numpy(tree: dict, device="cuda",
                          dtype=torch.float64) -> DualState:
    """A DualState from a dict of numpy arrays (nu, s, zL, zU)."""
    return _build(DualState, tree, resolve_device(device), dtype)


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
