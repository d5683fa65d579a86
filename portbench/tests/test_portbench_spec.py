"""BENCHMARK.json's fields against their allowed forms, every cell's files found
by name, and what the benchmark imports."""

import ast
import json
import pathlib
import re

import pytest

from portbench import run
from portbench.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["command"] == ["python3", "-m", "portbench.run"]
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group):
    entries = SPEC[group]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        # The contract lets a metric name its cells under "workloads"; the
        # harness reads no such key (a reader returns None where it finds
        # nothing to read), and no entry here has one.
        extra = {"workloads"} if group in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_names_across_groups():
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
        for key in ("nav_file", "motion_file"):
            if key in body:
                assert body[key].startswith("portbench/")
                assert (REPO / body[key]).is_file()


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(run.reader(m["name"], REPO))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(workload):
    w, cfg, traffic = run.cell(SPEC, workload, REPO)
    assert w["name"] == workload
    assert (REPO / "portbench" / "drivers" /
            f"{traffic['driver']}.py").is_file()
    e2e = run.metrics_of(SPEC, trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert run.metrics_of(SPEC, trace=True)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_anywhere():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((REPO / "portbench" / "reference").rglob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("portbench", "numpy", "torch", "math", "copy",
                           "re", "dataclasses", "typing", "__future__"), \
                (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)
