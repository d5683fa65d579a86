"""The port's receiver (gps_sdr_sim_tpu_torch.receiver) against the JAX
package's, on the CPU.

- The NumPy modules are copies: each one's source equals the JAX module's
  after the import-prefix rewrite; the copied helpers of acquire.py and
  track.py give the same outputs.
- Acquisition: the torch FFT search equals gps_sdr_sim_tpu.receiver.acquire
  ._acq_fn on the same blocks (argmax equal, peak and mean within 1e-4
  relative), and acquire() the same AcqResults.
- Tracking: over the 1.9 s capture, from the JAX acquisition, the torch
  loops stay within 1e-4 of max |prompt|, 0.01 Hz and 1e-3 chip of the JAX
  scan, with the same prompt sign at every ms.
- The CLI prints the JAX CLI's acquisition table, runs on the card unless
  given --cpu, and without a card exits 1 rather than fall back.

The capture is the static Tokyo scenario, 2 s at 2.048 Msps (1.9 s of
samples), synthesized once by the JAX package (impl="xla"). The tolerances
are gps_sdr_sim_tpu_torch.testing's; they hold only over short windows at
this rate (in a closed loop float32 rounding differences grow with time).
"""

import contextlib
import importlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.receiver import __main__ as jax_cli
from gps_sdr_sim_tpu.receiver.frontend import load_iq as jax_load_iq
from gps_sdr_sim_tpu.runner import run_simulation as jax_run_simulation
from gps_sdr_sim_tpu_torch import receiver
from gps_sdr_sim_tpu_torch.receiver import __main__ as cli
from gps_sdr_sim_tpu_torch.testing import (
    NAV,
    ROOT,
    RX_FS,
    TOKYO,
    check_acquisition,
    check_search,
    check_tracking,
    rx_table,
)

# The packages bind acquire and track to the functions; these are the
# modules of the same names.
acquire, track, jax_acquire, jax_track = (
    importlib.import_module(f"{pkg}.receiver.{mod}")
    for pkg in ("gps_sdr_sim_tpu_torch", "gps_sdr_sim_tpu")
    for mod in ("acquire", "track"))
FS = RX_FS
COPIED = ["frontend", "navdec", "ephdec", "pvt", "rinex", "rinexobs",
          "ambiguity", "rtk"]


@pytest.fixture(scope="module")
def capture():
    """The 2 s capture as SC16 bytes, from the JAX package."""
    scn = jax_scenario.build_scenario(jax_scenario.ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=2.0, samp_freq=FS,
        data_format=16))
    buf = io.BytesIO()
    jax_run_simulation(scn, buf, batch_epochs=16, impl="xla",
                       log=lambda s: None)
    return buf.getvalue()


@pytest.fixture(scope="module")
def x(capture):
    return jax_load_iq(capture, 16)


@pytest.fixture(scope="module")
def jax_acq(x):
    return jax_acquire.acquire(x, FS, dopp_step=50.0)


# ---------------------------------------------------------------------------
# Copies.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_equals_jax_source(name):
    ours = (ROOT / "gps_sdr_sim_tpu_torch" / "receiver" / f"{name}.py")
    ref = (ROOT / "gps_sdr_sim_tpu" / "receiver" / f"{name}.py")
    assert ours.read_text() == ref.read_text().replace(
        "gps_sdr_sim_tpu.", "gps_sdr_sim_tpu_torch.")


@pytest.mark.parametrize("fs", [1.023e6, 2.048e6, 2.6e6, 4.092e6])
def test_acquire_host_helpers_match(fs, x):
    np.testing.assert_array_equal(acquire.sampled_codes(fs),
                                  jax_acquire.sampled_codes(fs))
    s = int(round(fs * 1e-3))
    for a, b in zip(acquire.search_prep(x, fs, [3, 17], 2500.0, 125.0, 2),
                    jax_acquire.search_prep(x, fs, [3, 17], 2500.0, 125.0,
                                            2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(int(fs))
    prns, codes = [5, 9], acquire.sampled_codes(fs)[[4, 8]]
    dopp = np.arange(-500.0, 501.0, 250.0, dtype=np.float32)
    peak = rng.uniform(10, 40, 2).astype(np.float32)
    arg = rng.integers(0, len(dopp) * s, 2)
    mean = np.ones(2, np.float32)
    for threshold in (12.0, 30.0):
        assert acquire.assemble_results(
            x, fs, prns, codes, s, dopp, peak, arg, mean, threshold, True) \
            == [acquire.AcqResult(**vars(r)) for r in
                jax_acquire.assemble_results(x, fs, prns, codes, s, dopp,
                                             peak, arg, mean, threshold,
                                             True)]
    assert acquire._fine_doppler(x, fs, codes[0], 100, 250.0) == \
        jax_acquire._fine_doppler(x, fs, codes[0], 100, 250.0)


@pytest.mark.parametrize("bw", [0.5, 2.0, 18.0, 25.0])
def test_loop_gains_match(bw):
    assert track._loop_gains(bw, 1e-3) == jax_track._loop_gains(bw, 1e-3)


def test_track_result_and_spacing_match():
    assert list(track.TrackResult.__dataclass_fields__) == \
        list(jax_track.TrackResult.__dataclass_fields__)
    assert track._EL_SPACING == jax_track._EL_SPACING


# ---------------------------------------------------------------------------
# Acquisition.
# ---------------------------------------------------------------------------


def test_search_matches_jax_acq_fn(x):
    """All 32 PRNs, +-5 kHz in 50 Hz steps, 4 blocks of 1 ms."""
    prns, s, codes, dopp, xb = acquire.search_prep(x, FS, None, 5000.0,
                                                    50.0, 4)
    code_fft = np.fft.fft(codes, axis=-1).astype(np.complex64)
    want = jax_acquire._acq_fn(s, len(dopp), 4)(
        jnp.asarray(xb), jnp.asarray(code_fft), jnp.asarray(dopp),
        jnp.float32(FS))
    got = acquire.search(torch.from_numpy(xb), torch.from_numpy(code_fft),
                         torch.from_numpy(dopp), FS)
    assert len(prns) == 32 and len(dopp) == 201
    check_search([a.numpy() for a in got], [np.asarray(a) for a in want])


def test_acquire_matches_jax(x, jax_acq):
    ours = receiver.acquire(x, FS, dopp_step=50.0, device="cpu")
    check_acquisition(ours, [acquire.AcqResult(**vars(a)) for a in jax_acq])
    assert sum(a.detected for a in ours) == 13


# ---------------------------------------------------------------------------
# Tracking.
# ---------------------------------------------------------------------------


def test_tracking_matches_jax_scan(x, jax_acq):
    """1.9 s, 13 channels, both from the JAX acquisition."""
    want = jax_track.track(x, FS, jax_acq)
    got = receiver.track(x, FS, jax_acq, device="cpu")
    assert got.prompt.shape == (1900, 13)
    assert got.prompt.dtype == np.complex64
    assert got.doppler.dtype == got.code_phase.dtype == np.float32
    check_tracking(got, want)


def test_cpu_tracking_loop_runs_on_one_thread(x, jax_acq, monkeypatch):
    """The loop's small ops stall on intra-op threads when other processes
    share the cores; track() runs it on one CPU thread and restores the
    count after, also when the loop raises."""
    seen = []

    def loop(*args, **kw):
        seen.append(torch.get_num_threads())
        raise RuntimeError("stop")

    before = torch.get_num_threads()
    monkeypatch.setattr(track, "track_loop", loop)
    with pytest.raises(RuntimeError, match="stop"):
        receiver.track(x[:4096], FS, jax_acq, device="cpu")
    assert seen == [1] and torch.get_num_threads() == before


def test_track_refuses_no_channels(x, jax_acq):
    with pytest.raises(ValueError, match="no detected channels"):
        receiver.track(x, FS, [a for a in jax_acq if not a.detected],
                       device="cpu")


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture_file(capture, tmp_path_factory):
    path = tmp_path_factory.mktemp("rx") / "capture.bin"
    path.write_bytes(capture)
    return str(path)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_cli_matches_jax_cli(capture_file):
    argv = [capture_file, "-s", "2048000", "-d", "0.1", "--cpu"]
    rc, out, err = _run(cli.main, argv)
    jrc, jout, jerr = _run(jax_cli.main, argv)
    assert rc == jrc == 0
    assert err == jerr
    ours, ref = rx_table(out), rx_table(jout)
    assert len(ours) == len(ref) == 13
    for a, b in zip(ours, ref):
        assert a[:3] == b[:3]
        assert abs(float(a[3]) - float(b[3])) <= 0.1


@pytest.mark.parametrize("argv", [
    ["--pvt"], ["--rinex-obs", "o.obs"], ["--track", "1", "--pvt-track", "1"],
    ["-b", "4"]])
def test_cli_usage_errors_match_jax_cli(capture_file, argv):
    rc, out, err = _run(cli.main, [capture_file] + argv)
    jrc, jout, jerr = _run(jax_cli.main, [capture_file] + argv)
    assert rc == jrc == 2
    assert (out, err) == (jout, jerr)


def test_cli_without_a_card_exits_1(capture_file, monkeypatch):
    """No quiet fallback: without --cpu the receiver needs the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(cli.main, [capture_file, "-s", "2048000"])
    assert rc == 1 and out == ""
    assert "--cpu" in err


@pytest.mark.parametrize("flags, device", [([], "cuda"), (["--cpu"], "cpu")])
def test_cli_runs_on_the_card_unless_given_cpu(capture_file, monkeypatch,
                                               flags, device):
    """With a card present, acquisition and tracking get the CUDA device;
    with --cpu, the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def spy(fn):
        def run(*args, device, **kw):
            seen.append(torch.device(device).type)
            return fn(*args, device="cpu", **kw)
        return run

    monkeypatch.setattr(receiver, "acquire", spy(receiver.acquire))
    monkeypatch.setattr(receiver, "track", spy(receiver.track))
    rc, out, _ = _run(cli.main, [capture_file, "-s", "2048000", "--track",
                                 "0.3"] + flags)
    assert rc == 0 and seen == [device, device]
    assert "subframes" in out


_NO_JAX = r"""
import sys
sys.modules["jax"] = sys.modules["gps_sdr_sim_tpu"] = None
import runpy
sys.argv[0] = "gps_sdr_sim_tpu_torch.receiver"
try:
    runpy.run_module("gps_sdr_sim_tpu_torch.receiver", run_name="__main__")
finally:
    assert not any(m.split(".")[0] in ("jax", "gps_sdr_sim_tpu")
                   for m in sys.modules if sys.modules[m] is not None)
"""


def test_receiver_cli_runs_without_jax(capture_file):
    """python -m gps_sdr_sim_tpu_torch.receiver --cpu, with every import of
    jax or the JAX package made to fail."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, capture_file, "-s", "2048000",
         "--track", "0.6", "--cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(rx_table(proc.stdout)) == 13
