"""A copy of the benchmark's files with one tiny cell added as new files
only: half a second of the circle run at 1 Msps through the plain
`torch-sharded` impl on the CPU, every epoch checked."""

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY = "tiny.plain"


def add_cell(root: pathlib.Path, name: str, config: dict, traffic: dict,
             metrics=()) -> None:
    """Add cell `name` (configuration `name`.split(".")[0]) as new files
    and BENCHMARK.json entries; metrics: [(entry, reader source)]."""
    cfg_name, traffic_name = name.split(".", 1)
    (root / "portbench" / "configs" / f"{cfg_name}.json").write_text(
        json.dumps(config))
    (root / "portbench" / "traffic" / f"{traffic_name}.json").write_text(
        json.dumps(traffic))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cfg_name, "source": "test",
                            "file": f"portbench/configs/{cfg_name}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": cfg_name,
                              "traffic": traffic_name, "chips": 1,
                              "why": "test"})
    for entry, source in metrics:
        (root / "portbench" / "metrics" / f"{entry['name']}.py").write_text(
            source)
        spec["per_layer"].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


TINY_CONFIG = {"source": "test", "nav_file": "portbench/data/brdc3540.14n",
               "motion_file": "portbench/data/circle.csv", "duration": 0.6,
               "iono": True, "carrier_phase_mode": "float", "reduced": []}
TINY_TRAFFIC = {"driver": "epoch_range", "impl": "torch-sharded",
                "mesh": [1, 1], "data_format": 16, "samp_freq": 1.0e6,
                "batch_epochs": 2, "check_stride_epochs": 1}


@pytest.fixture
def checkout(tmp_path):
    """A copy of BENCHMARK.json and portbench/ with the tiny cell."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_cell(tmp_path, TINY, TINY_CONFIG, TINY_TRAFFIC)
    return tmp_path
