"""The port's runner and CLI (gps_sdr_sim_tpu_torch) on the CPU: the C-
reference goldens, byte and stderr parity with the JAX CLI, the refusals,
and that the port runs without JAX."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu_torch.testing import (
    NAV,
    ROOT,
    SCENARIOS,
    check,
    load_goldens,
    synthesize,
)

STATIC = ["-e", str(NAV), "-l", "35.681298,139.766247,10.0", "-d", "0.3",
          "-s", "1000000", "--batch-epochs", "2"]


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_through_port_runner(goldens, name):
    ours = synthesize(name, impl="torch", device=torch.device("cpu"))
    check(ours, goldens[name], SCENARIOS[name]["data_format"])


def _strip_stderr(err: str) -> list:
    lines = err.replace("\r", "\n").splitlines()
    return [ln for ln in lines if ln and not ln.startswith(
        ("Process time", "Throughput", "Time into run"))]


@pytest.mark.parametrize("extra", [[], ["-b", "1", "-v"]])
def test_cli_matches_jax_cli(tmp_path, capsys, extra):
    ours, ref = tmp_path / "ours.bin", tmp_path / "ref.bin"
    assert main(STATIC + extra + ["-o", str(ours), "--impl", "torch",
                                  "--device", "cpu"]) == 0
    err_ours = capsys.readouterr().err
    assert jax_main(STATIC + extra + ["-o", str(ref), "--impl", "xla"]) == 0
    err_ref = capsys.readouterr().err
    assert ours.read_bytes() == ref.read_bytes()
    assert _strip_stderr(err_ours) == _strip_stderr(err_ref)


def test_default_impl_needs_cuda(tmp_path, capsys):
    """No silent CPU fallback: the default --impl cuda on a machine without
    a usable CUDA device exits 1 with an ERROR line, as does --impl cuda
    on a CPU device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(STATIC + ["-o", str(tmp_path / "x.bin")])
    assert e.value.code == 1
    assert "ERROR: CUDA device 'cuda' is not available." in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(STATIC + ["-o", str(tmp_path / "x.bin"), "--device", "cpu"])
    assert "ERROR: impl 'cuda' runs the CUDA kernel and needs a CUDA " \
        "device, got 'cpu'" in capsys.readouterr().err
    assert not (tmp_path / "x.bin").exists()


@pytest.mark.parametrize("flag", [
    ["--shard-dir", "d"], ["--shards", "2"], ["--resume"], ["--concat"],
    ["--multihost", "h:1,0,2"], ["--profile", "p"]])
def test_unported_flags_refused(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as e:
        main(STATIC + ["-o", str(tmp_path / "x.bin"), "--impl", "torch",
                       "--device", "cpu"] + flag)
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert re.search(r"ERROR: --[a-z-]+ is not yet supported by the torch "
                     r"port", err), err


def test_runner_rejects_cuda_impl_on_cpu():
    from gps_sdr_sim_tpu_torch.runner import run_simulation
    from gps_sdr_sim_tpu_torch.testing import golden_scenario

    with pytest.raises(ValueError, match="needs a CUDA device"):
        run_simulation(golden_scenario("static16"), None, impl="cuda",
                       device="cpu")


def test_fetch_event_recorded_on_outputs_stream(monkeypatch):
    """The readback's event goes on the stream of the output's device,
    where the copy is queued, not on the current device's stream."""
    from gps_sdr_sim_tpu_torch.runner import fetch_async

    recorded = []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    class Out:
        device = torch.device("cuda", 1)

        def to(self, where, non_blocking=False):
            assert where == "cpu" and non_blocking
            return "host"

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    host, done = fetch_async(Out())
    assert host == "host" and isinstance(done, Event)
    assert recorded == [("stream of", torch.device("cuda", 1))]


_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import gps_sdr_sim_tpu_torch, gps_sdr_sim_tpu_torch.cli
import gps_sdr_sim_tpu_torch.runner, gps_sdr_sim_tpu_torch.testing
import gps_sdr_sim_tpu_torch.ops.synth, gps_sdr_sim_tpu_torch.ops.synth_cuda
import gps_sdr_sim_tpu_torch.ops.quantize
rc = gps_sdr_sim_tpu_torch.cli.main(sys.argv[1:])
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None), "jax was imported"
sys.exit(rc)
"""


def test_port_runs_without_jax(tmp_path):
    """A subprocess: tests/conftest.py has already imported JAX here."""
    out = tmp_path / "nojax.bin"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-e", str(NAV), "-l",
         "35.681298,139.766247,10.0", "-d", "0.2", "-s", "1000000",
         "--impl", "torch", "--device", "cpu", "-o", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.stat().st_size == 100000 * 4  # one 0.1 s epoch of SC16
    assert np.count_nonzero(np.fromfile(out, np.int16)) > 0
