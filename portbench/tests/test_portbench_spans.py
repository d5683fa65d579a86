"""The two metrics that read the program's spans, planner_ms_per_batch and
enqueue_ms_per_batch, in whole runs of the tiny cell on the CPU: both in a
traced run's line, their sum within plan_ms_per_batch, one runner.plan span
per batch of the window, and neither in an untraced run."""

import json
import sys

import pytest
import torch

from gps_sdr_sim_tpu_torch import spans
from portbench import run
from portbench.drivers import epoch_range
from portbench.tests.conftest import TINY

CPU = torch.device("cpu")
SEED = 2**31 + 11


@pytest.fixture
def windows(monkeypatch):
    """The Window of every run, as epoch_range.window returns it."""
    seen = []
    window = epoch_range.window

    def keep(*args, **kwargs):
        seen.append(window(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(epoch_range, "window", keep)
    return seen


def _line(checkout, capsys, trace: int) -> dict:
    spans.reset()
    rc = run.main(["--workload", TINY, "--seed", str(SEED), "--seconds",
                   "0.2", "--trace", str(trace)], device=CPU, root=checkout)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def test_traced_run_splits_plan_ms_per_batch(checkout, capsys, windows):
    line = _line(checkout, capsys, 1)
    assert line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["planner_ms_per_batch"] > 0 and m["enqueue_ms_per_batch"] > 0
    assert m["planner_ms_per_batch"] + m["enqueue_ms_per_batch"] <= \
        m["plan_ms_per_batch"]
    assert line["metrics"]["planner_ms_per_batch"]["unit"] == "ms"
    (win,) = windows
    table = spans.totals()
    assert table["runner.plan"][0] == win.stats["device_batches"] > 0
    # The table's runner.plan seconds are RunStats' own clock reads.
    assert table["runner.plan"][1] == pytest.approx(
        win.stats["plan_seconds"], rel=1e-9)


def test_untraced_run_reports_neither(checkout, capsys, windows):
    line = _line(checkout, capsys, 0)
    assert line["correct"] is True
    assert not {"planner_ms_per_batch", "enqueue_ms_per_batch"} & \
        set(line["metrics"])
    assert spans.totals() == {}
    assert windows[0].stats["device_batches"] > 0


@pytest.mark.parametrize("table", ["empty", "missing"])
@pytest.mark.parametrize("name", ["planner_ms_per_batch",
                                  "enqueue_ms_per_batch"])
def test_reader_is_silent_without_spans(checkout, monkeypatch, name, table):
    """An empty table (an untraced window) or none at all (a program that
    opens no spans) gives None, not 0, and raises nothing."""
    spans.reset()
    if table == "missing":
        import gps_sdr_sim_tpu_torch

        monkeypatch.delattr(gps_sdr_sim_tpu_torch, "spans")
        monkeypatch.setitem(sys.modules, "gps_sdr_sim_tpu_torch.spans", None)
    read = run.reader(name, checkout)
    assert read(run.Run(TINY, 0.0, None, None, object())) is None
    assert read(run.Run(TINY, 0.0, None, None, None)) is None
