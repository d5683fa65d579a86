"""The port's runner and CLI (gps_sdr_sim_tpu_torch) on the CPU: the C-
reference goldens, byte and stderr parity with the JAX CLI (over the cases
of tests/test_cli.py and more, through the plain versions and the closed
form), the errors of the shard and multihost flags, the counts below 1
that the CLI, the runner and the tools refuse (ROADMAP C4), and that the
port runs without JAX (--profile is tested in test_torch_tools.py)."""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import gps_sdr_sim_tpu.cli as jax_cli
import gps_sdr_sim_tpu_torch.cli as port_cli
from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu.parallel import writer as jax_writer
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu_torch.testing import (
    DATA,
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


# The cases of tests/test_cli.py and beyond, each run by the port's CLI
# (plain versions on the CPU) and the JAX CLI (--impl xla): input errors,
# motion scenarios, position and time, formats and modes.
_LLH = "35.681298,139.766247,10.0"
_RUN = ["-d", "0.3", "-s", "1000000", "--batch-epochs", "2"]
CLI_CASES = {
    "bad_format": ["-b", "12"],
    "bad_rate": ["-s", "999999"],
    "bad_start_time": ["-t", "2020/01/01,00:00:00", "-d", "0.1"],
    "missing_motion_file": ["-u", "no_such_file.csv", "-d", "0.3"],
    "satellite_motion_size": ["-u", str(DATA / "satellite.csv"), "-i",
                              *_RUN, "-d", "0.4", "--motion-size", "4000"],
    "satellite_default_size": ["-u", str(DATA / "satellite.csv"), "-i",
                               *_RUN, "-d", "0.4"],
    "static_wins_over_motion": ["-l", _LLH, "-u", str(DATA / "circle.csv"),
                                *_RUN],
    "zero_duration_dynamic": ["-u", str(DATA / "circle.csv"), "-s",
                              "1000000", "-d", "0"],
    "negative_ecef": ["-c", "-2694685.473,-4293642.366,3857878.924", *_RUN],
    "nmea": ["-g", str(DATA / "triumphv3.txt"), *_RUN],
    "rocket": ["-u", str(DATA / "rocket.csv"), *_RUN],
    "later_start": ["-l", _LLH, "-t", "2014/12/20,02:00:00", *_RUN],
    "toc_override": ["-l", _LLH, "-T", "2015/01/01,00:00:00", *_RUN],
    "sub_epoch": ["-l", _LLH, *_RUN, "-d", "0.05"],
    "altitude_30km": ["-l", "35.681298,139.766247,30000", *_RUN],
    "sc08_2048": ["-l", _LLH, *_RUN, "-b", "8", "-s", "2048000"],
    "sc01_1023": ["-l", _LLH, *_RUN, "-b", "1", "-s", "1023000"],
    # 2 * iq_buff_size % 8 != 0: the C reference overflows its SC01 buffer
    # here (docs/PARITY.md, known bugs); the CLIs drop the partial byte.
    "sc01_odd_rate": ["-l", _LLH, "-d", "0.3", "-s", "1000100", "-b", "1",
                      "--batch-epochs", "2"],
    "fixed_carrier": ["-l", _LLH, *_RUN, "--carrier-phase", "fixed"],
    "no_iono_verbose": ["-l", _LLH, *_RUN, "-i", "-v"],
    "motion_size_10": ["-u", str(DATA / "circle.csv"), *_RUN,
                       "--motion-size", "10"],
}


def _usage_lines(module) -> set:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        module._usage()
    return set(err.getvalue().splitlines())


def _without_usage(err: str, module) -> list:
    """_strip_stderr with the usage text folded into one line: the two
    CLIs' usage texts differ in their name and extension lines."""
    usage, out = _usage_lines(module), []
    for ln in _strip_stderr(err):
        if ln not in usage:
            out.append(ln)
        elif not out or out[-1] != "<usage>":
            out.append("<usage>")
    return out


def _exit_code(fn, argv) -> int:
    try:
        return fn(argv)
    except SystemExit as e:
        return e.code


@pytest.fixture
def one_torch_thread():
    """Run torch on one thread: the suite runs several test processes on a
    few cores, and small ops stall on contended intra-op threads (ROADMAP
    C3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("impl", ["torch", "closed"])
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_cases_match_jax_cli(tmp_path, capsys, case, impl):
    """Exit code, output bytes (or no file) and stderr equal the JAX
    CLI's."""
    ours, ref = tmp_path / "ours.bin", tmp_path / "ref.bin"
    argv = ["-e", str(NAV), *CLI_CASES[case]]
    want = _exit_code(jax_main, argv + ["-o", str(ref), "--impl", "xla"])
    err_ref = capsys.readouterr().err
    got = _exit_code(main, argv + ["-o", str(ours), "--impl", impl,
                                   "--device", "cpu"])
    err = capsys.readouterr().err
    assert got == want
    assert ours.exists() == ref.exists()
    if ref.exists():
        assert ours.read_bytes() == ref.read_bytes()
    assert _without_usage(err, port_cli) == _without_usage(
        err_ref, jax_cli)
    assert err.strip()


@pytest.mark.parametrize("argv", [
    ["--batch-epochs", "0"], ["--batch-epochs", "-1"], ["--shards", "0"],
    ["--shard-dir", "{tmp}/s", "--shards", "-2"]])
def test_cli_rejects_counts_below_one(tmp_path, capsys, argv):
    """C4: the JAX CLI loops forever on --batch-epochs 0 or -1 and divides
    by zero on --shards 0; the port exits 1 with an ERROR line, as it does
    for -s and -b, and writes nothing."""
    out = tmp_path / "x.bin"
    flag = argv[-2]
    rc, error = _exit_and_error(main, STATIC + [
        a.format(tmp=tmp_path) for a in argv] + [
        "-o", str(out), "--impl", "torch", "--device", "cpu"], capsys)
    assert (rc, error) == (1, f"ERROR: {flag} must be at least 1.")
    assert not out.exists()


@pytest.mark.parametrize("batch_epochs", [0, -1])
def test_runner_rejects_batch_epochs_below_one(batch_epochs):
    from gps_sdr_sim_tpu_torch.runner import (
        iter_seg_batches,
        run_epoch_range,
    )
    from gps_sdr_sim_tpu_torch.testing import golden_scenario

    scn = golden_scenario("static16")
    buf = io.BytesIO()
    with pytest.raises(ValueError, match="batch_epochs must be at least 1"):
        run_epoch_range(scn, buf, 0, scn.n_output_epochs,
                        batch_epochs=batch_epochs, impl="torch",
                        device="cpu")
    with pytest.raises(ValueError, match="batch_epochs must be at least 1"):
        next(iter_seg_batches(scn, 0, scn.n_output_epochs, batch_epochs))
    assert buf.getvalue() == b""


@pytest.mark.parametrize("tool, argv, error", [
    ("bench_scaling", ["--device", "cpu", "--epochs-per-device", "0"],
     "epochs_per_device must be at least 1, got 0"),
    ("dayrun", ["--device", "cpu", "--batch-epochs", "0"],
     "batch_epochs must be at least 1, got 0"),
    ("dayrun", ["--device", "cpu", "--drain-epochs", "-1"],
     "drain_epochs must be at least 1, got -1"),
    ("dayrun", ["--phase", "diff", "--block-epochs", "0"],
     "--block-epochs must be at least 1."),
    ("deepcheck", ["--block-epochs", "0"],
     "--block-epochs must be at least 1."),
])
def test_tools_reject_counts_below_one(tmp_path, capsys, tool, argv, error):
    import importlib

    module = importlib.import_module(f"gps_sdr_sim_tpu_torch.tools.{tool}")
    files = (["--json", str(tmp_path / "d.json"), "--blocks-file",
              str(tmp_path / "b.npz")] if tool == "dayrun" else [])
    assert _exit_and_error(module.main, argv + files, capsys) == (
        1, f"ERROR: {error}")
    assert list(tmp_path.iterdir()) == []


def test_tool_functions_reject_counts_below_one():
    from gps_sdr_sim_tpu_torch.tools import bench_scaling, dayrun, deepcheck

    with pytest.raises(ValueError, match="epochs_per_device must be at"):
        bench_scaling.sweep(device="cpu", epochs_per_device=0)
    cfg = deepcheck.static_config(1.0e6, 1.0)
    for kw in ({"batch_epochs": 0}, {"drain_epochs": 0},
               {"block_epochs": -3}):
        with pytest.raises(ValueError, match=f"{next(iter(kw))} must be"):
            dayrun.synth_day(cfg, device="cpu", **kw)


def test_runner_rejects_cuda_impl_on_cpu():
    from gps_sdr_sim_tpu_torch.runner import run_simulation
    from gps_sdr_sim_tpu_torch.testing import golden_scenario

    with pytest.raises(ValueError, match="needs a CUDA device"):
        run_simulation(golden_scenario("static16"), None, impl="cuda",
                       device="cpu")


def test_fetch_event_recorded_on_outputs_stream(monkeypatch):
    """The readback of a piece on cuda:1 goes on the copy stream passed in
    for cuda:1: that stream first waits for cuda:1's current stream (not
    the current device's), where the piece was written; the copy and its
    done event go on it; and the piece is recorded as in use on it."""
    from gps_sdr_sim_tpu_torch.runner import fetch_async

    log = []

    class Stream:
        def __init__(self, name):
            self.name = name

        def wait_stream(self, other):
            log.append(("wait", self.name, other))

        def record_event(self):
            log.append(("event", self.name))
            return "done"

    class StreamContext:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            log.append(("enter", self.stream.name))

        def __exit__(self, *exc):
            log.append(("exit", self.stream.name))

    class Out:
        device = torch.device("cuda", 1)

        def to(self, where, non_blocking=False):
            assert where == "cpu" and non_blocking
            log.append(("copy",))
            return "host"

        def record_stream(self, stream):
            log.append(("record_stream", stream.name))

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("current stream of", device))
    monkeypatch.setattr(torch.cuda, "stream", StreamContext)
    host, done = fetch_async(Out(), Stream("copy:1"))
    assert (host, done) == ("host", "done")
    assert log[:4] == [
        ("wait", "copy:1", ("current stream of", torch.device("cuda", 1))),
        ("enter", "copy:1"), ("copy",), ("exit", "copy:1")]
    assert sorted(log[4:]) == [("event", "copy:1"),
                               ("record_stream", "copy:1")]


def test_runner_makes_one_copy_stream_per_card_per_call(monkeypatch):
    """run_epoch_range reads every batch's pieces back on one copy stream
    per card that holds a piece, made once in a call and reused by each of
    its batches; a CPU piece is written as it is, with no copy."""
    from gps_sdr_sim_tpu_torch import runner
    from gps_sdr_sim_tpu_torch.testing import golden_scenario

    made, fetched = [], []

    class Stream:
        def __init__(self, device):
            made.append(self)
            self.device = device

    class Piece:
        def __init__(self, device, rows):
            self.device = device
            self.rows = rows

    def outputs(scn, seg, e, e1, batch_epochs, impl, device, mesh,
                nav_gather):
        rows = torch.full((e1 - e, 1, 2), e, dtype=torch.int16)
        return [Piece(torch.device("cuda", 1), rows),
                Piece(torch.device("cuda", 0), rows[:0]),
                rows[:0]]

    def fetch_async(out, copy_stream):
        assert copy_stream.device == out.device
        fetched.append(copy_stream)
        return out.rows, None

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(runner, "synth_batch_outputs", outputs)
    monkeypatch.setattr(runner, "fetch_async", fetch_async)
    scn = golden_scenario("static16", duration=0.7)
    n = scn.n_output_epochs
    assert n > 4  # more batches than the writer's queue holds
    for call in range(2):
        buf = io.BytesIO()
        stats = runner.run_epoch_range(scn, buf, 0, n, batch_epochs=1,
                                       log=lambda s: None, impl="closed",
                                       device="cpu")
        assert stats.device_batches == n
        assert np.frombuffer(buf.getvalue(), np.int16).tolist() == \
            [e for e in range(n) for _ in range(2)]
        streams = made[2 * call:]
        assert len(streams) == 2
        assert {s.device for s in streams} == {torch.device("cuda", 0),
                                                torch.device("cuda", 1)}
        assert fetched[2 * n * call:] == [streams[0], streams[1]] * n


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("samp_freq", [2.6e6, 1_000_100.0])
@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_every_impl_gives_pieces_in_pack_form(fmt, samp_freq):
    """synth_batch_outputs hands the runner one output form: torch (the
    kernel's words cut on the device), torch-sharded on a 1x1 mesh and
    closed give the same dtype, shape and values, pack's form, also at an
    odd rate whose SC01 epochs end in a partial byte (sc01_odd_rate)."""
    from gps_sdr_sim_tpu_torch.models.scenario import (
        ScenarioConfig,
        build_scenario,
    )
    from gps_sdr_sim_tpu_torch.parallel.mesh import make_mesh
    from gps_sdr_sim_tpu_torch.runner import (
        iter_seg_batches,
        synth_batch_outputs,
    )
    from gps_sdr_sim_tpu_torch.testing import TOKYO

    cpu = torch.device("cpu")
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), duration=0.2, samp_freq=samp_freq,
        static_xyz=TOKYO, data_format=fmt))
    ((seg, e, e1),) = iter_seg_batches(scn, 0, 2, 2)
    n = scn.iq_buff_size
    dtype = {16: torch.int16, 8: torch.int8, 1: torch.uint8}[fmt]
    shape = (2, n // 4) if fmt == 1 else (2, n, 2)
    got = {}
    for impl in ("torch", "torch-sharded", "closed"):
        mesh = make_mesh(1, 1, [cpu]) if impl.endswith("-sharded") else None
        (piece,) = synth_batch_outputs(scn, seg, e, e1, 2, impl, cpu, mesh)
        assert piece.dtype == dtype, impl
        assert tuple(piece.shape) == shape, impl
        assert piece.is_contiguous(), impl
        got[impl] = piece
    assert torch.count_nonzero(got["closed"]) > 0
    for impl in ("torch", "torch-sharded"):
        assert torch.equal(got[impl], got["closed"]), impl


def test_flush_writes_each_piece_from_its_own_memory(monkeypatch):
    """The writer hands the sink each fetched piece's valid rows as a
    buffer over the piece's own memory, one write a piece, with no host
    copy; a piece past the batch's valid epochs is not written."""
    from gps_sdr_sim_tpu_torch import runner
    from gps_sdr_sim_tpu_torch.testing import golden_scenario

    handed = []

    def outputs(scn, seg, e, e1, batch_epochs, impl, device, mesh,
                nav_gather):
        # Two time shards of a two-epoch batch, the second padded past the
        # valid epochs, then a piece of padding only.
        pieces = [torch.full((1, 3, 2), e, dtype=torch.int16),
                  torch.full((2, 3, 2), e + 1, dtype=torch.int16),
                  torch.zeros((1, 3, 2), dtype=torch.int16)]
        handed.append(pieces[:e1 - e])
        return pieces

    class Sink:
        def __init__(self):
            self.writes = []

        def write(self, data):
            self.writes.append(data)

    monkeypatch.setattr(runner, "synth_batch_outputs", outputs)
    scn = golden_scenario("static16", duration=0.6)
    n = scn.n_output_epochs
    assert n % 2 == 1  # the last batch leaves its second shard unwritten
    sink = Sink()
    stats = runner.run_epoch_range(scn, sink, 0, n, batch_epochs=2,
                                   log=lambda s: None, impl="closed",
                                   device="cpu")
    written = [p for pieces in handed for p in pieces]
    assert stats.device_batches == len(handed)
    assert len(sink.writes) == len(written) == n
    for data, piece in zip(sink.writes, written):
        buf = np.frombuffer(data, np.uint8)
        assert buf.size == 3 * 2 * 2  # one epoch's row
        assert np.shares_memory(buf, piece.numpy())
    assert b"".join(bytes(w) for w in sink.writes) == np.repeat(
        np.arange(n, dtype=np.int16), 6).tobytes()


_NO_JAX = r"""
import sys
# Any import of jax, of the JAX package, of the root tools or of the root
# __graft_entry__ now raises ImportError.
BLOCKED = ("jax", "gps_sdr_sim_tpu", "tools", "__graft_entry__", "bench",
           "bench_scaling", "deepcheck", "dayrun")
for name in BLOCKED:
    sys.modules[name] = None
import gps_sdr_sim_tpu_torch, gps_sdr_sim_tpu_torch.cli
import gps_sdr_sim_tpu_torch.runner, gps_sdr_sim_tpu_torch.testing
import gps_sdr_sim_tpu_torch.ops.synth, gps_sdr_sim_tpu_torch.ops.synth_cuda
import gps_sdr_sim_tpu_torch.ops.quantize, gps_sdr_sim_tpu_torch.parallel
import gps_sdr_sim_tpu_torch.receiver.__main__, gps_sdr_sim_tpu_torch.receiver.rtk
import gps_sdr_sim_tpu_torch.receiver.pvt, gps_sdr_sim_tpu_torch.receiver.rinex
import gps_sdr_sim_tpu_torch.entry, gps_sdr_sim_tpu_torch.tools.dayrun
import gps_sdr_sim_tpu_torch.tools.deepcheck
rc = gps_sdr_sim_tpu_torch.cli.main(sys.argv[1:])
assert not any(m.split(".")[0] in BLOCKED
               for m in sys.modules if sys.modules[m] is not None), \
    "jax, gps_sdr_sim_tpu or a root tool was imported"
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
