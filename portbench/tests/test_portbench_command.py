"""The command: it refuses to run without a card (or without the
program beside it), and on a card each cell runs to a correct result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def command(root, cell, seconds, trace=0, seed=2 ** 31 + 99):
    return subprocess.run(
        [sys.executable, str(Path(root) / "portbench" / "run.py"),
         "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=root, capture_output=True, text=True,
        timeout=600)


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_refuses_without_a_card():
    if _has_card():
        pytest.skip("a CUDA device is present")
    p = command(ROOT, BENCH["workloads"][0]["name"], 1)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path, BENCH["workloads"][0]["name"], 1)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not _has_card():
        pytest.skip("needs a CUDA device")
    for trace in (0, 1):
        p = command(ROOT, cell, 2, trace)
        assert p.returncode == 0, p.stderr[-4000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] is True, out["checks"]
        assert out["device"]["platform"] == "gpu"
        if trace:
            assert out["device"]["busy_s"] > 0
