"""The port's span table (gps_sdr_sim_tpu_torch/spans.py) on the CPU: off
while no profiler records (no clock read, no profiler range, an empty
table), and under torch.profiler one count per batch of every per-batch
span, children within their parents, the runner's spans on RunStats' own
clock reads, every declared name in the profiler's host events, the bytes
unchanged, and the table safe under threads."""

import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu_torch import spans
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu_torch.models.scenario import (
    ScenarioConfig,
    build_scenario,
)
from gps_sdr_sim_tpu_torch.parallel.mesh import make_mesh
from gps_sdr_sim_tpu_torch.runner import run_simulation
from gps_sdr_sim_tpu_torch.testing import DATA, NAV, TOKYO

CPU = torch.device("cpu")
IMPLS = ("torch", "torch-sharded", "closed", "closed-sharded")
# 0.6 s at 1 Msps is five 0.1 s output epochs: one-epoch batches through a
# queue of four, one leaves it inside the batch loop, four in the drain.
BATCHES = 5

# The spans each impl opens once per batch (runner.run and runner.drain
# are once per call).
PER_BATCH = {
    "torch": {"runner.plan", "plan.plan_epochs", "plan.pad_epochs",
              "plan.pack_epoch_wire", "synth.upload", "synth.launch",
              "quantize.pack", "runner.fetch_async", "runner.fetch",
              "runner.write"},
    "torch-sharded": {"runner.plan", "plan.plan_epochs", "plan.pad_epochs",
                      "plan.pack_epoch_wire", "synth.upload",
                      "synth.launch", "shard.stack", "quantize.pack",
                      "runner.fetch_async", "runner.fetch", "runner.write"},
    "closed": {"runner.plan", "plan.plan_batch", "plan.pad_epochs",
               "synth.upload", "synth.launch", "quantize.pack",
               "runner.fetch_async", "runner.fetch", "runner.write"},
    "closed-sharded": {"runner.plan", "plan.plan_batch", "plan.pad_epochs",
                       "synth.upload", "synth.launch", "shard.stack",
                       "quantize.pack", "runner.fetch_async",
                       "runner.fetch", "runner.write"},
}
# What runner.plan holds: the planner, then the enqueue.
PLAN_CHILDREN = ("plan.plan_epochs", "plan.plan_batch", "plan.pad_epochs",
                 "plan.pack_epoch_wire", "synth.upload", "synth.launch",
                 "shard.stack", "quantize.pack", "runner.fetch_async")


@pytest.fixture(scope="module")
def scenarios():
    """A static SC16 run and a circle SC08 run, 0.6 s at 1 Msps."""
    return {
        "static16": build_scenario(ScenarioConfig(
            nav_file=str(NAV), duration=0.6, samp_freq=1.0e6,
            static_xyz=TOKYO, data_format=16)),
        "circle8": build_scenario(ScenarioConfig(
            nav_file=str(NAV), duration=0.6, samp_freq=1.0e6,
            motion_file=str(DATA / "circle.csv"), data_format=8)),
    }


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several test processes on a few
    cores, and small ops stall on contended intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


def _run(scn, impl: str):
    """(bytes, RunStats) of `scn` through `impl` on the CPU, one-epoch
    batches, a 1x1 mesh for the sharded impls."""
    buf = io.BytesIO()
    mesh = make_mesh(1, 1, [CPU]) if impl.endswith("-sharded") else None
    stats = run_simulation(scn, buf, batch_epochs=1, log=lambda s: None,
                           impl=impl, device=CPU, mesh=mesh)
    return buf.getvalue(), stats


def _profiled(scn, impl: str):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        data, stats = _run(scn, impl)
    return data, stats, prof


def test_the_range_is_the_fast_one_where_torch_has_it():
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    assert spans.RANGE is (fast or torch.profiler.record_function)


@pytest.mark.parametrize("impl", ["torch", "torch-sharded"])
def test_off_reads_no_clock_and_opens_no_range(scenarios, monkeypatch, impl):
    def refuse(*args, **kwargs):
        raise AssertionError("a span acted with no profiler recording")

    monkeypatch.setattr(spans, "_clock", refuse)
    monkeypatch.setattr(spans, "RANGE", refuse)
    monkeypatch.setattr(spans, "_range", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("runner.plan") is spans.span("synth.launch", 3)
    data, stats = _run(scenarios["static16"], impl)
    assert stats.device_batches == BATCHES
    assert len(data) == BATCHES * 100_000 * 4
    assert spans.totals() == {}


@pytest.mark.parametrize("impl", IMPLS)
def test_one_count_per_batch_and_children_within_parents(scenarios, impl):
    _, stats, _ = _profiled(scenarios["circle8"], impl)
    table = spans.totals()
    assert stats.device_batches == BATCHES
    assert set(table) == PER_BATCH[impl] | {"runner.run", "runner.drain"}
    assert set(table) <= set(spans.NAMES)
    for name in PER_BATCH[impl]:
        assert table[name][0] == stats.device_batches, name
    assert table["runner.run"][0] == table["runner.drain"][0] == 1
    secs = {k: s for k, (_, s) in table.items()}
    assert sum(secs.get(k, 0.0) for k in PLAN_CHILDREN) <= \
        secs["runner.plan"]
    if impl == "torch":
        # One output form: the packed words are cut to pack's form inside
        # runner.plan, as the sharded impl packs its stacked samples.
        assert set(table) == (PER_BATCH["torch-sharded"] - {"shard.stack"}
                              | {"runner.run", "runner.drain"})
    assert secs["runner.plan"] + secs["runner.fetch"] + \
        secs["runner.write"] <= secs["runner.run"]
    assert secs["runner.drain"] <= secs["runner.run"] - secs["runner.plan"]


@pytest.mark.parametrize("impl", ["torch", "closed-sharded"])
def test_runner_spans_are_runstats_clock_reads(scenarios, impl):
    _, stats, _ = _profiled(scenarios["static16"], impl)
    table = spans.totals()
    for name, field in (("runner.plan", "plan_seconds"),
                        ("runner.fetch", "fetch_seconds"),
                        ("runner.write", "write_seconds"),
                        ("runner.run", "wall_seconds")):
        assert table[name][1] == pytest.approx(getattr(stats, field),
                                               rel=1e-12, abs=1e-12), name


def test_every_declared_name_is_a_host_event(scenarios):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for impl in IMPLS:
            _run(scenarios["static16"], impl)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert set(spans.NAMES) <= names
    assert set(spans.totals()) == set(spans.NAMES)


@pytest.mark.parametrize("impl", IMPLS)
def test_bytes_unchanged_with_the_profiler_on(scenarios, impl):
    plain, _ = _run(scenarios["circle8"], impl)
    traced, _, _ = _profiled(scenarios["circle8"], impl)
    assert traced == plain


def test_undeclared_name_is_refused_while_recording():
    with spans.span("no.such.span"):   # off: the shared no-op
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="undeclared span"):
            with spans.span("no.such.span"):
                pass
    assert spans.totals() == {}


def test_table_is_safe_under_threads():
    """More threads than cores, switching often: no count or nanosecond is
    lost (a lost update of the table would show)."""
    per_thread, n_threads = 500, (os.cpu_count() or 1) + 2

    def work():
        for _ in range(per_thread):
            with spans.span("synth.upload"):
                pass
            spans.end(spans.begin("synth.launch"), "synth.launch", 5)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    table = spans.totals()
    assert table["synth.upload"][0] == per_thread * n_threads
    assert table["synth.launch"][0] == per_thread * n_threads
    assert table["synth.launch"][1] == pytest.approx(
        5e-9 * per_thread * n_threads, rel=1e-12)


def test_cli_profile_trace_carries_spans_and_batches(tmp_path, capsys):
    """--profile's trace holds the runner's spans, runner.plan, .fetch and
    .write each with its batch's number."""
    prof = tmp_path / "prof"
    assert main(["-e", str(NAV), "-l", "35.681298,139.766247,10.0", "-d",
                 "0.3", "-s", "1000000", "--batch-epochs", "1", "--impl",
                 "torch", "--device", "cpu", "-o", str(tmp_path / "p.bin"),
                 "--profile", str(prof)]) == 0
    capsys.readouterr()
    (trace,) = prof.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert PER_BATCH["torch"] | {"runner.run", "runner.drain"} <= names
    epochs = np.fromfile(tmp_path / "p.bin", np.uint8).size // 400_000
    assert epochs >= 2
    for name in ("runner.plan", "runner.fetch", "runner.write"):
        batches = sorted(e["args"]["batch"] for e in events
                         if e.get("name") == name)
        assert batches == list(range(epochs)), name
