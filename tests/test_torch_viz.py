"""obca_torch's trajectory figures against obca_tpu's.

``ego_corners`` within 1e-12 of the JAX package's on random poses (from
numpy arrays and from tensors); the PNG and frame cases of
``tests/test_viz.py`` on the port's spec and interpolated states; and
``import obca_torch`` (with ``viz``) leaves matplotlib unimported.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from obca_torch import reverse_parking_spec, viz
from obca_torch import spec as tspec
from obca_torch.warmstart import geometric
from obca_tpu import viz as jviz

# The test run puts several pytest-xdist workers on the host's cores;
# torch's default thread pool per worker oversubscribes them.
torch.set_num_threads(1)


def test_ego_corners_match_jax():
    rng = np.random.default_rng(0)
    g = np.array([3.7, 1.0, 1.0, 1.0])
    for x in np.column_stack([rng.uniform(-8, 8, 16), rng.uniform(-8, 8, 16),
                              rng.uniform(-np.pi, np.pi, 16),
                              rng.uniform(-1, 2, 16)]):
        want = jviz.ego_corners(x, g)
        np.testing.assert_allclose(viz.ego_corners(x, g), want, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(
            viz.ego_corners(torch.tensor(x), torch.tensor(g)), want, rtol=0,
            atol=1e-12)


def test_plot_trajectory_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    spec = reverse_parking_spec(N=10, Ts=1.0, device="cpu")
    X = geometric.interpolated_states(tspec.stack([spec]))[0]
    U = torch.zeros((spec.N, 2), dtype=torch.float64)
    out = viz.plot_trajectory(spec, X, U, path=str(tmp_path / "t.png"),
                              title="smoke")
    assert (tmp_path / "t.png").stat().st_size > 0
    assert out.endswith("t.png")


def test_animation_frames(tmp_path):
    pytest.importorskip("matplotlib")
    spec = reverse_parking_spec(N=6, Ts=1.0, device="cpu")
    X = geometric.interpolated_states(tspec.stack([spec]))[0]
    paths = viz.save_animation_frames(spec, X, str(tmp_path), stride=3)
    assert len(paths) == 3
    for p in paths:
        assert (tmp_path / os.path.basename(p)).stat().st_size > 0


def test_import_leaves_matplotlib_unimported():
    code = textwrap.dedent("""
        import sys
        import obca_torch
        import obca_torch.viz
        assert "matplotlib" not in sys.modules
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
