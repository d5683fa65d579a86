"""The port's runner and CLI (gps_sdr_sim_tpu_torch) on the CPU: the C-
reference goldens, byte and stderr parity with the JAX CLI, the errors of
the shard and multihost flags, and that the port runs without JAX
(--profile is tested in test_torch_tools.py)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import gps_sdr_sim_tpu_torch.cli as port_cli
from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu.parallel import writer as jax_writer
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


def _exit_and_error(fn, argv, capsys):
    """(exit code, ERROR line) of one CLI call, whether it returns its
    code or raises SystemExit."""
    try:
        rc = fn(argv)
    except SystemExit as e:
        rc = e.code
    errors = [ln for ln in capsys.readouterr().err.splitlines()
              if ln.startswith("ERROR:")]
    return rc, errors[-1] if errors else None


def _without_a_shard(module, monkeypatch):
    """Make the run_simulation_sharded that `module` calls lose shard 1
    after writing, as a process that died would."""
    real = module.run_simulation_sharded

    def lossy(scn, out_dir, **kw):
        out = real(scn, out_dir, **kw)
        os.remove(os.path.join(out_dir, "shard_00001.bin"))
        return out

    monkeypatch.setattr(module, "run_simulation_sharded", lossy)


@pytest.mark.parametrize("case", [
    "multihost_without_shard_dir", "malformed_multihost", "resume_elsewhere",
    "concat_missing_shard", "cuda_sharded_without_card"])
def test_shard_flag_errors_match_jax_cli(tmp_path, capsys, monkeypatch,
                                         case):
    """Each error of the shard and multihost flags exits 1 with an ERROR
    line, the JAX CLI's own where the JAX CLI can run the case. It cannot
    run two: with a shard missing, its --concat raises (the port's ERROR
    line carries that exception's text), and it has no cuda-sharded."""
    out = ["-o", str(tmp_path / "x.bin")]
    port = ["--impl", "torch", "--device", "cpu"]
    jax = ["--impl", "xla"]
    shards = ["--shard-dir", str(tmp_path / "s"), "--shards", "2"]
    want = None
    if case == "multihost_without_shard_dir":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            free = sock.getsockname()[1]
        argv = out + ["--multihost", f"127.0.0.1:{free},0,1"]
        # jax.distributed can start only in a fresh process.
        proc = subprocess.run(
            [sys.executable, "-m", "gps_sdr_sim_tpu.cli", *STATIC, *argv,
             *jax], cwd=ROOT, capture_output=True, text=True, timeout=300)
        want = (proc.returncode, [ln for ln in proc.stderr.splitlines()
                                  if ln.startswith("ERROR:")][-1])
    elif case == "malformed_multihost":
        argv = out + shards + ["--multihost", "127.0.0.1:1;0"]
    elif case == "resume_elsewhere":
        other = ["-e", str(NAV), "-l", "10.0,20.0,30.0", "-d", "0.3", "-s",
                 "1000000", "--batch-epochs", "2"]
        assert main(other + out + shards + port) == 0
        argv = out + shards + ["--resume"]
    elif case == "concat_missing_shard":
        argv = out + shards + ["--concat"]
        _without_a_shard(jax_writer, monkeypatch)
        _without_a_shard(port_cli, monkeypatch)
        with pytest.raises(FileNotFoundError) as e:
            jax_main(STATIC + argv + jax)
        capsys.readouterr()
        want = (1, f"ERROR: {e.value}")
    elif case == "cuda_sharded_without_card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        argv = out + shards
        port = ["--impl", "cuda-sharded"]
        want = (1, "ERROR: CUDA device 'cuda' is not available.")
    if want is None:
        want = _exit_and_error(jax_main, STATIC + argv + jax, capsys)
    got = _exit_and_error(main, STATIC + argv + port, capsys)
    assert got == want
    assert got[0] == 1 and got[1].startswith("ERROR: ")


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
# Any import of jax or of the JAX package now raises ImportError.
sys.modules["jax"] = sys.modules["gps_sdr_sim_tpu"] = None
import gps_sdr_sim_tpu_torch, gps_sdr_sim_tpu_torch.cli
import gps_sdr_sim_tpu_torch.runner, gps_sdr_sim_tpu_torch.testing
import gps_sdr_sim_tpu_torch.ops.synth, gps_sdr_sim_tpu_torch.ops.synth_cuda
import gps_sdr_sim_tpu_torch.ops.quantize, gps_sdr_sim_tpu_torch.parallel
import gps_sdr_sim_tpu_torch.receiver.__main__, gps_sdr_sim_tpu_torch.receiver.rtk
import gps_sdr_sim_tpu_torch.receiver.pvt, gps_sdr_sim_tpu_torch.receiver.rinex
rc = gps_sdr_sim_tpu_torch.cli.main(sys.argv[1:])
assert not any(m.split(".")[0] in ("jax", "gps_sdr_sim_tpu")
               for m in sys.modules if sys.modules[m] is not None), \
    "jax or gps_sdr_sim_tpu was imported"
sys.exit(rc)
"""


@pytest.mark.parametrize("extra", [
    [], ["--impl", "torch-sharded", "--shard-dir", "{tmp}/s", "--concat"]])
def test_port_runs_without_jax(tmp_path, extra):
    """A subprocess: tests/conftest.py has already imported JAX here."""
    out = tmp_path / "nojax.bin"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-e", str(NAV), "-l",
         "35.681298,139.766247,10.0", "-d", "0.2", "-s", "1000000",
         "--impl", "torch", "--device", "cpu", "-o", str(out)]
        + [a.format(tmp=tmp_path) for a in extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.stat().st_size == 100000 * 4  # one 0.1 s epoch of SC16
    assert np.count_nonzero(np.fromfile(out, np.int16)) > 0
