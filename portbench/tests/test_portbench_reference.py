"""The plain reference against the port's plain path, the yardstick's work
count against a hand count, and the trace's reduction."""

import io
import json

import numpy as np
import pytest
import torch

from portbench import peaks
from portbench.drivers.epoch_range import scenario_config
from portbench.reference import scenario as rs
from portbench.reference import synth as rsyn
from portbench.tests.conftest import REPO, TINY_CONFIG, TINY_TRAFFIC
from portbench.trace import reduce_events


def _config(name):
    return json.loads((REPO / "portbench" / "configs" /
                       f"{name}.json").read_text())


def _traffic(name):
    return json.loads((REPO / "portbench" / "traffic" /
                       f"{name}.json").read_text())


def _port_bytes(cfg, traffic, lo, hi):
    from gps_sdr_sim_tpu_torch.models import scenario
    from gps_sdr_sim_tpu_torch.runner import run_epoch_range

    scn = scenario.build_scenario(scenario_config(scenario, cfg, traffic,
                                                  REPO))
    buf = io.BytesIO()
    run_epoch_range(scn, buf, lo, hi, batch_epochs=hi - lo,
                    log=lambda s: None, impl="torch-sharded", device="cpu")
    return buf.getvalue()


# Two epochs across a segment boundary of each configuration at its own
# sample rate (static300's channel count changes from 11 to 12 at 2100).
@pytest.mark.parametrize("config,lo", [("circle300", 299),
                                       ("static300", 2099)])
def test_reference_equals_port_plain(config, lo):
    cfg, traffic = _config(config), _traffic("sc16.sharded")
    got = _port_bytes(cfg, traffic, lo, lo + 2)
    rscn = rs.build_scenario(scenario_config(rs, cfg, traffic, REPO))
    want = b"".join(rsyn.epoch_bytes(rscn, e, "cpu", 16)
                    for e in (lo, lo + 1))
    assert len(got) == len(want) == 2 * rscn.iq_buff_size * 4
    assert got == want


@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_reference_formats_equal_port_plain(fmt):
    traffic = dict(TINY_TRAFFIC, data_format=fmt)
    got = _port_bytes(TINY_CONFIG, traffic, 1, 3)
    rscn = rs.build_scenario(scenario_config(rs, TINY_CONFIG, traffic, REPO))
    want = b"".join(rsyn.epoch_bytes(rscn, e, "cpu", fmt) for e in (1, 2))
    assert got == want


def test_control_differs():
    traffic = dict(TINY_TRAFFIC)
    rscn = rs.build_scenario(scenario_config(rs, TINY_CONFIG, traffic, REPO))
    a = rsyn.epoch_bytes(rscn, 2, "cpu")
    b = rsyn.epoch_bytes(rscn, 2, "cpu", precision="float32")
    assert len(a) == len(b) and a != b


def test_least_time_hand_count():
    # 13 channels with gain, 260,000 samples: 14 * 13 + 4 = 186 operations
    # a sample, 48.36 M an epoch, 1.4436 ms per 100 epochs at 33.5 T/s;
    # its 1.04 MB of SC16 and 2.3 KB of inputs take 0.31 ms at 3.35 TB/s.
    t = peaks.epoch_least_seconds(np.array([13, 0]), 260_000, 16)
    assert t[0] == pytest.approx(260_000 * 186 / 33.5e12, rel=1e-12)
    assert t[0] * 100 * 1e3 == pytest.approx(0.14436, rel=1e-4)
    # No channel: the bytes bound it.
    assert t[1] == pytest.approx(260_000 * 4 / 3.35e12, rel=1e-12)
    assert peaks.output_bytes(260_001, 1) == 65_000


def test_reduce_events():
    ms = 1_000_000
    device = [(0, 2 * ms, "k", "kernel"),
              (1 * ms, 5 * ms, "Memcpy DtoH", "dtoh"),
              (8 * ms, 9 * ms, "k", "kernel")]
    host = [(0, 10 * ms, "portbench.call", ),
            (5 * ms, 6 * ms, "cudaEventSynchronize"),
            (7 * ms, 8 * ms, "aten::to")]
    s = reduce_events(device, host, 0.010)
    assert s.busy_s == pytest.approx(0.006)
    assert s.kernel_s == pytest.approx(0.003)
    assert s.dtoh_s == pytest.approx(0.004)
    # The one gap, 5-8 ms, has its middle at 6.5 ms: only the call span
    # covers it, so it is named by the next host event.
    assert s.idle_gaps == [["before_aten::to", pytest.approx(0.003)]]
    assert s.device_ops[0] == ["Memcpy DtoH", pytest.approx(0.004)]


def test_tracer_on_cpu():
    from portbench.trace import Tracer

    tr = Tracer("cpu")
    tr.start()
    with torch.profiler.record_function("portbench.call"):
        torch.ones(10).sum()
    tr.stop(0.01)
    s = tr.summary()
    assert s.busy_s == 0 and s.device_ops == [] and s.window_s == 0.01
