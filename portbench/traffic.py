"""The one traffic generator: requests drawn from a mix's parameters and
the run's seed.

A mix file (``portbench/traffic/<name>.json``) states its kind
(``sweep``: one batched solve of ``lanes`` start poses a request;
``mpc``: one closed-loop maneuver of ``lanes`` vehicles a request), the
lanes of a request, and ``shift``: the half-widths of the uniform draws
added to the first state components of the configuration's start pose,
drawn in ``shift_dtype``.  The rest of the file holds the solver
settings of that kind of request.

Request i of seed s draws from ``numpy.random.default_rng([s, i])``:
request 0 is the warm-up, requests 1, 2, ... are the window's.  So a
request is a pure function of the seed and its index, whatever ran
before it.

A mix with ``pool``: P gives every seed the same set of P window
requests, in another order: pool element j draws from
``default_rng([pool_seed, j])``, and request i >= 1 of seed s is element
``permutation_s[(i - 1) % P]``, the permutation drawn from
``default_rng([s])``.  For requests whose cost varies much from draw to
draw (a maneuver that runs its re-solves to the cap), so that the seed
orders the work and does not change it.
"""

from __future__ import annotations

import numpy as np


def start_poses(mix, x0, seed, index):
    """Start poses [lanes, len(x0)] (float64) of request ``index``."""
    x0 = np.asarray(x0, np.float64)
    shift = np.asarray(mix["shift"], np.float64)
    key = [int(seed), int(index)]
    if "pool" in mix and index >= 1:
        P = int(mix["pool"])
        perm = np.random.default_rng([int(seed)]).permutation(P)
        key = [int(mix["pool_seed"]), int(perm[(index - 1) % P])]
    rng = np.random.default_rng(key)
    d = rng.uniform(-1.0, 1.0, size=(int(mix["lanes"]), len(shift)))
    d = (d * shift).astype(np.dtype(mix["shift_dtype"]))
    out = np.tile(x0, (int(mix["lanes"]), 1))
    out[:, :len(shift)] += d
    return out
