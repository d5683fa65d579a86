"""Whole runs of the tiny cell on the CPU (the plain impl, the harness's look
for a card skipped), their result line, a cell added as new files, the
control and the faults that `correct` has to catch."""

import json
import sys

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.tests.conftest import TINY, TINY_CONFIG, TINY_TRAFFIC, add_cell

CPU = torch.device("cpu")
SEED = 2**31 + 9


def _main(checkout, capsys, *extra, workload=TINY, seed=SEED):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.2", *extra], device=CPU, root=checkout)
    out, err = capsys.readouterr()
    return rc, out, err


def test_trace0_last_line(checkout, capsys):
    rc, out, err = _main(checkout, capsys, "--trace", "0")
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checked"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {"rt_factor", "setup_s"} <= set(line["metrics"])
    assert line["checked"] == {"wrong_bytes": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-1] == "checked wrong_bytes 0 limit 0"


def test_trace1_per_layer(checkout, capsys):
    rc, out, _ = _main(checkout, capsys, "--trace", "1")
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checked"
    assert {"plan_ms_per_batch", "fetch_ms_per_batch"} <= set(line["metrics"])
    assert "rt_factor" not in line["metrics"]
    # No device on the CPU: the device-trace metrics stay silent, never 0.
    assert "synth_roofline" not in line["metrics"]
    assert "window_s" in line["device"] and "breakdown" in line


def test_cell_added_as_new_files(checkout, capsys):
    # A cell and a per-layer metric of its own, as new files and entries
    # only; the metric's reader finds nothing to read in other cells.
    reader = ("def read(run):\n"
              "    if run.workload != 'static1.sc08':\n"
              "        return None\n"
              "    return float(run.window.delivered_epochs)\n")
    entry = {"name": "epochs_delivered", "unit": "epochs",
             "better": "higher", "source": "program_counter",
             "layer": "test", "moves": "rt_factor"}
    add_cell(checkout, "static1.sc08",
             dict(TINY_CONFIG, static_llh=[30.286502, 120.032669, 100.0],
                  motion_file=None),
             dict(TINY_TRAFFIC, data_format=8), [(entry, reader)])
    rc, out, _ = _main(checkout, capsys, "--trace", "1",
                       workload="static1.sc08")
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["epochs_delivered"]["value"] >= 1
    rc, out, _ = _main(checkout, capsys, "--trace", "1")
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert "epochs_delivered" not in line["metrics"]
    assert "plan_ms_per_batch" in line["metrics"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "circle300.sc16.sharded", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA" in err


def test_forbidden_modules(checkout, capsys, monkeypatch):
    assert run.forbidden_modules() == []
    assert "gps_sdr_sim_tpu_torch" in sys.modules
    monkeypatch.setitem(sys.modules, "gps_sdr_sim_tpu.ops", object())
    assert run.forbidden_modules() == ["gps_sdr_sim_tpu"]
    rc, out, err = _main(checkout, capsys)
    assert rc == 3 and out == "" and "gps_sdr_sim_tpu" in err


def test_control_fails_and_program_passes(checkout):
    out = control.readings(TINY, [11, 12], [13, 14, 15], 0.2, device=CPU,
                           root=checkout, control_stride=1)
    assert out["lower"] == {"wrong_bytes": 0}
    assert out["upper"]["wrong_bytes"] > 0
    assert all(r["failed"] > 0 for r in out["control"])
    assert all(r["failed"] == 0 for r in out["program"])


def _break(monkeypatch, fault):
    """Break the timed path under the runner: `stale` hands back the
    previous batch's output (a step that returns its state unchanged),
    `half` leaves out half the epochs of each batch (silence), `altered`
    changes one sample of every epoch where it is produced."""
    from gps_sdr_sim_tpu_torch import runner

    real = runner.synth_batch_outputs
    last = []

    def broken(*args, **kwargs):
        outs = real(*args, **kwargs)
        if fault == "stale":
            if last:
                outs = last[0]
            else:
                last.append(outs)
        elif fault == "half":
            for o in outs:
                o[o.shape[0] // 2:] = 0
        elif fault == "altered":
            for o in outs:
                o.view(torch.uint8).reshape(o.shape[0], -1)[:, 7] ^= 1
        return outs

    monkeypatch.setattr(runner, "synth_batch_outputs", broken)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_not_correct(checkout, monkeypatch, fault):
    _break(monkeypatch, fault)
    line = run.run_cell(TINY, SEED, 0.2, False, device=CPU, root=checkout)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checked"]["wrong_bytes"]["value"] > 0


def test_sink_keeps_the_seeds_epochs():
    from portbench.drivers.epoch_range import Sink

    eb = 8
    kept = []
    for seed in (1, 2):
        sink = Sink(eb, 3, np.random.default_rng(seed), traced=False)
        sink.begin_call(4, 10)
        data = np.arange(6 * eb, dtype=np.uint8)
        sink.write(data[:4 * eb].data)
        sink.write(data[4 * eb:].data)
        assert sink.bytes == 6 * eb and len(sink.call_times[0]) == 2
        for epoch, got in sink.kept:
            assert got == data[(epoch - 4) * eb:(epoch - 3) * eb].tobytes()
        kept.append([e for e, _ in sink.kept])
    again = Sink(eb, 3, np.random.default_rng(1), traced=False)
    again.begin_call(4, 10)
    again.write(np.arange(6 * eb, dtype=np.uint8).data)
    assert [e for e, _ in again.kept] == kept[0]
