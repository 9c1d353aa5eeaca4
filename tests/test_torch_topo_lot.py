"""The benchmark's cluttered reverse-parking lot (``reverse_topo_n80_f32``,
cell ``reverse_topo_sweep_b128``) on the CPU.

* ``layout``: the family file's base problem is the layout that
  ``randomized_reverse_parking_specs(..., vary_topology=True)`` builds
  when every draw lands on the midpoint of its range and every topology
  option is on: nz = 72 (nw 43, nc 29), exactly two padded faces, every
  leaf equal in float64;
* ``starts_clear``: every start pose the traffic mix can draw (x, y
  +-0.5 m, heading +-0.15) clears every obstacle by the generator's own
  rejection margin d_min + 0.02: the exact SAT clearance over a dense
  grid of the shift box, less how far the distance can move between
  grid points (the harness does not rejection-sample);
* ``judged``: the harness's control run of the cell at N = 20, Ts = 1.2
  and 4 lanes: the program's answers pass ``check.judge`` under the
  cell's limits, and the control (the same answers in bfloat16) fails
  them.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from obca_torch import nlp
from obca_torch import spec as tspec
from portbench import check, control, harness

torch.set_num_threads(1)

CELL = "reverse_topo_sweep_b128"
SMALL = {"config": {"N": 20, "Ts": 1.2}, "traffic": {"lanes": 4}}
CPU = torch.device("cpu")


class _Midpoints:
    """Stands in for the generator's ``np.random.Generator``: every
    uniform draw is the midpoint of its range and every ``random()`` is
    0, so each topology option (bevels, wall, parked car) is taken."""

    def uniform(self, lo, hi, size=None):
        mid = 0.5 * (lo + hi)
        return mid if size is None else np.full(size, mid)

    def random(self):
        return 0.0


def _generator_layout(monkeypatch, N, Ts):
    monkeypatch.setattr(tspec.np.random, "default_rng",
                        lambda seed=None: _Midpoints())
    _, layouts, _ = tspec.randomized_reverse_parking_specs(
        1, n_layouts=1, N=N, Ts=Ts, vary_topology=True,
        dtype=torch.float64, device=CPU)
    return tspec.take(layouts, 0)


def _check_layout(monkeypatch):
    from portbench.families import reverse_topo

    _, cfg, _, _ = harness.cell(harness.benchmark(), CELL)
    prob, base = reverse_topo.base_spec(cfg, CPU, torch.float64)
    L = nlp.layout_of(base)
    assert prob is nlp
    assert (L.nw, L.nc, L.nz) == (43, 29, 72)
    assert (base.max_obs, base.max_faces) == (4, 5)
    fmask = base.obstacles.face_mask
    assert fmask.sum() == 18 and fmask[:2].all()
    assert fmask[2:, 4].eq(0).all() and fmask[2:, :4].all()
    assert base.obstacles.obs_mask.all()

    gen = _generator_layout(monkeypatch, cfg["N"], cfg["Ts"])
    # The generator puts the goal at the block top less the ego's front
    # overhang, 5.0 - 3.7, which float64 rounds to 1.2999999999999998;
    # the configuration states the paper's 1.3.
    torch.testing.assert_close(gen.xF, base.xF, rtol=0, atol=1e-15)
    gen = dataclasses.replace(gen, xF=base.xF)
    got, want = tspec.tensor_leaves(base), tspec.tensor_leaves(gen)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (base.N, base.max_obs, base.max_faces, base.fix_time,
            base.signed) == (gen.N, gen.max_obs, gen.max_faces,
                             gen.fix_time, gen.signed)


def _check_starts_clear():
    _, cfg, mix, _ = harness.cell(harness.benchmark(), CELL)
    # The box the harness draws from: shifts rounded to float32.
    sx, sy, spsi = np.asarray(mix["shift"], np.float32).astype(float)
    h, hpsi = 0.025, 0.0075
    x = cfg["x0"][0] + np.arange(-sx, sx + 1e-9, h)
    y = cfg["x0"][1] + np.arange(-sy, sy + 1e-9, h)
    psi = cfg["x0"][2] + np.arange(-spsi, spsi + 1e-9, hpsi)
    X, Y, P = (a.ravel() for a in np.meshgrid(x, y, psi, indexing="ij"))
    clear = tspec._np_sat_clearance(X, Y, P, cfg["ego_g"], cfg["obstacles"])
    # The distance to the obstacles is at least the SAT clearance, and
    # between grid points it moves at most as far as the ego's points
    # do: half a step in x and in y, and half a heading step times the
    # farthest corner's distance from the rear axle.
    front, rear, wl, wr = cfg["ego_g"]
    reach = max(np.hypot(front, max(wl, wr)), np.hypot(rear, max(wl, wr)))
    slack = np.hypot(h / 2, h / 2) + reach * hpsi / 2
    assert clear.min() - slack >= cfg["d_min"] + 0.02, (clear.min(), slack)


def _check_judged(capsys):
    control.main(["--workload", CELL, "--seconds", "0", "--seeds",
                  str(2 ** 31 + 16)], device=CPU, overrides=SMALL)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = row["limits"]
    assert row["attempted"] == 4 and row["failed"] == 0, row
    assert check.judge(row["program"], limits)[0], row
    assert not check.judge(row["control"], limits)[0], row


@pytest.mark.parametrize("case", ["layout", "starts_clear", "judged"])
def test_topo_lot(case, monkeypatch, capsys):
    if case == "layout":
        _check_layout(monkeypatch)
    elif case == "starts_clear":
        _check_starts_clear()
    else:
        _check_judged(capsys)
