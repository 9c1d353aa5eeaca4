"""The benchmark's files: everything BENCHMARK.json names is found by
name, the contract's limits on names, units and sizes hold, and no
module of the benchmark loads JAX, the JAX package or the TPU benchmark,
or reads a file of the TPU benchmark's folder."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "obca_tpu", "bench", "chip_smoke"}


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_found_by_name():
    for wl in BENCH["workloads"]:
        w, cfg, mix, limits = harness.cell(BENCH, wl["name"])
        assert w is wl or w == wl
        assert cfg["name"] == wl["config"]
        assert mix["kind"] in ("sweep", "mpc")
        assert limits and set(limits) <= {"pri", "stat", "comp", "clear",
                                          "ws", "loop"}
        assert wl["chips"] == 1
        e2e = harness.metrics_of(BENCH, wl["name"], trace=False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.metrics_of(BENCH, wl["name"], trace=True)


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
            assert w in moved[0].get("workloads", [w])


def test_configs_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["precision"]["iterate"] in ("float32", "float64")
        assert "round" in cfg["control"]
        assert (ROOT / "portbench" / "reference"
                / f"{cfg['reference']}.py").exists()
        assert (ROOT / "portbench" / "families"
                / f"{cfg['family']}.py").exists()


def test_every_warm_start_and_route_found_by_name():
    import obca_torch

    from portbench import program

    for wl in BENCH["workloads"]:
        _, cfg, mix, _ = harness.cell(BENCH, wl["name"])
        assert (ROOT / "portbench" / "warmstarts"
                / f"{mix['warm_start']}.py").exists()
        assert hasattr(obca_torch, f"{cfg['solver']['route']}_solver_config")
        assert program.solver_config(cfg, 7).max_iter == 7


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_forbidden_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not set(_imports(path)) & {"obca_torch", "obca_tpu", "jax"}


def test_no_file_names_the_tpu_benchmark():
    pat = re.compile(r"(?<![A-Za-z0-9_])bench" + "/")
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".md",
                                                ".txt", ".sh"):
            text = path.read_text()
            assert not pat.search(text.replace("portbench/", "")), path
