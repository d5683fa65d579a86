"""The port's day-run and deepcheck tools (gps_sdr_sim_tpu_torch.tools.dayrun
and .deepcheck) on the CPU.

- The full-day scenario (86,400 s, static Tokyo, 2.6 Msps, SC16) through
  the tool's synth phase with --device cpu: the sampled block one hour in
  has the sha256 recorded in DAYRUN_r05.json, whose blocks the C reference
  verified.
- A short run that crosses a 30 s segment boundary: its wrapped checksum,
  least nonzero count and sampled blocks equal what the JAX package
  computes with runner.run_epoch_range(impl="xla") on the materialized
  scenario and its checksum_packed, batch by batch.
- The producer's errors surface; stream_sample keeps its ranges and
  refuses a stream of the wrong size; diff's pass rule and straddle
  classification; the oracle phases without the C reference; no card.

Everything is exact integer arithmetic: tolerance zero."""

import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.ops.quantize import checksum_packed as jax_checksum
from gps_sdr_sim_tpu.runner import iter_seg_batches as jax_batches
from gps_sdr_sim_tpu.runner import run_epoch_range as jax_run_epoch_range
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools import dayrun, deepcheck

RECORDED = json.loads((ROOT / "DAYRUN_r05.json").read_text())
# A small geometry for the file tests: 1 s at 1 Msps is 9 output epochs;
# 2-epoch blocks with one filler give the blocks [0, 2) and [3, 5).
SMALL = ["--duration", "1", "--samp-freq", "1e6", "--block-epochs", "2",
         "--filler-blocks", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch on one thread here: the suite runs several test processes
    on a few cores, and these ops stall on contended intra-op threads
    (ROADMAP C3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(tmp_path):
    return ["--json", str(tmp_path / "day.json"),
            "--blocks-file", str(tmp_path / "blocks.npz"),
            "--oracle-blocks-file", str(tmp_path / "oracle.npz")]


def test_full_day_block_matches_recorded_sha256(tmp_path):
    """Block [36000, 36020) of the day, planned by streaming through the
    first hour, synthesized by the plain version."""
    assert dayrun.main(["--device", "cpu", "--only-blocks", "36000",
                        *_files(tmp_path)]) == 0
    stats = json.loads((tmp_path / "day.json").read_text())
    want = RECORDED["block_sha256"]["36000"]
    assert stats["sampled_blocks"] == [[36000, 36020]]
    assert stats["block_sha256"] == {"36000": want}
    assert stats["epochs"] == RECORDED["epochs"]
    block = np.load(tmp_path / "blocks.npz")["b36000"]
    assert block.size == 20 * 260000 * 4
    assert hashlib.sha256(block.tobytes()).hexdigest() == want


def test_short_run_matches_jax_package():
    """31 s at 200 ksps in 100-epoch batches: the first 30 s segment (300
    epochs) gives three batches of 100, the second segment one of 9,
    padded to 100."""
    cfg = deepcheck.static_config(2.0e5, 31.0)
    B = 100
    run = dayrun.synth_day(cfg, batch_epochs=B, drain_epochs=200,
                           block_epochs=5, filler_blocks=3, device="cpu",
                           log=lambda s: None)
    st = run.stats

    scn = jax_scenario.build_scenario(jax_scenario.ScenarioConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    n, total = scn.iq_buff_size, scn.n_output_epochs
    buf = io.BytesIO()
    jax_run_epoch_range(scn, buf, 0, total, batch_epochs=B, impl="xla",
                        log=lambda s: None)
    stream = np.frombuffer(buf.getvalue(), np.int32).reshape(total, n)
    sums, nonzero, lo = [], [], 0
    geometry = []
    for seg, e0, e1 in jax_batches(scn, 0, total, B):
        s, z = jax_checksum(jnp.asarray(stream[lo:lo + e1 - e0]), e1 - e0,
                            n, 16)
        sums.append(s)
        nonzero.append(int(z))
        geometry.append(e1 - e0)
        lo += e1 - e0
    assert geometry == [100, 100, 100, 9]
    assert st["batches"] == len(geometry)
    assert st["checksum_wrapped_int32"] == int(jnp.sum(jnp.stack(sums)))
    assert st["min_batch_nonzero"] == min(nonzero)
    blocks = deepcheck.pick_blocks(scn, 5, 3)
    assert st["sampled_blocks"] == [list(b) for b in blocks]
    raw = buf.getvalue()
    for b_lo, b_hi in blocks:
        want = raw[b_lo * n * 4:b_hi * n * 4]
        assert run.blocks[b_lo] == want, b_lo
        assert st["block_sha256"][str(b_lo)] == \
            hashlib.sha256(want).hexdigest()


def test_producer_error_raises_in_synth_day(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("planner failed")

    monkeypatch.setattr(dayrun, "plan_epochs", boom)
    with pytest.raises(RuntimeError, match="planner failed"):
        dayrun.synth_day(deepcheck.static_config(1.0e6, 1.0),
                         block_epochs=2, device="cpu", log=lambda s: None)


_PRODUCER_FAILS = """
import sys
from gps_sdr_sim_tpu_torch.tools import dayrun
def boom(*args, **kwargs):
    raise RuntimeError("planner failed")
dayrun.plan_epochs = boom
sys.exit(dayrun.main(sys.argv[1:]))
"""


def test_producer_error_exits_nonzero(tmp_path):
    """As a process: a traceback and a nonzero exit, not a hang."""
    proc = subprocess.run(
        [sys.executable, "-c", _PRODUCER_FAILS, "--device", "cpu", *SMALL,
         *_files(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    assert "RuntimeError: planner failed" in proc.stderr
    assert not (tmp_path / "day.json").exists()


def _writer(n_bytes: int) -> list:
    """A stand-in oracle: writes bytes 0..255 repeated, n_bytes in all."""
    return [sys.executable, "-c",
            f"import sys; sys.stdout.buffer.write((bytes(range(256)) * "
            f"{n_bytes // 256 + 1})[:{n_bytes}])"]


def test_stream_sample_keeps_its_ranges():
    data = (bytes(range(256)) * 40)[:10240]
    ranges = [(0, 10), (5000, 5100), (10200, 10240)]
    kept = deepcheck.stream_sample(_writer(10240), ranges, 10240)
    assert {lo: bytes(b) for lo, b in kept.items()} == {
        lo: data[lo:hi] for lo, hi in ranges}
    # A range that spans the sampler's 4 MiB reads.
    big = 3 << 21
    kept = deepcheck.stream_sample(_writer(big), [(100, big - 100)], big)
    assert bytes(kept[100]) == (bytes(range(256)) * (big // 256))[100:-100]


@pytest.mark.parametrize("written, expected", [(1000, 1024), (1024, 1000)])
def test_stream_sample_refuses_wrong_size(written, expected):
    with pytest.raises(RuntimeError, match=f"oracle wrote {written} bytes, "
                                           f"expected {expected}"):
        deepcheck.stream_sample(_writer(written), [(0, 10)], expected)


def test_stream_sample_refuses_failed_oracle():
    with pytest.raises(RuntimeError, match="oracle exited 3"):
        deepcheck.stream_sample([sys.executable, "-c", "exit(3)"],
                                [(0, 10)], 0)


def _block_files(tmp_path, change=None):
    """Two block files of the SMALL geometry: random SC16 samples, and a
    copy with change(int16 samples of block 3) applied."""
    rng = np.random.default_rng(6)
    ours = {lo: rng.integers(-3000, 3000, (hi - lo) * 100000 * 2,
                             dtype=np.int16).tobytes()
            for lo, hi in ((0, 2), (3, 5))}
    ref = dict(ours)
    if change is not None:
        samples = np.frombuffer(ours[3], np.int16).copy()
        change(samples)
        ref[3] = samples.tobytes()
    dayrun.save_blocks(tmp_path / "blocks.npz", ours)
    dayrun.save_blocks(tmp_path / "oracle.npz", ref,
                       oracle_wall_s=np.float64(1.5))


def _set(*values):
    """Add 100 to the I and Q values at these interleaved indices."""
    def change(samples):
        samples[list(values)] += 100
    return change


@pytest.mark.parametrize("case, change, rc, straddles, hard", [
    ("equal", None, 0, 0, 0),
    ("one isolated sample", _set(2000, 2001), 0, 1, 0),
    ("a cluster of three samples", _set(2000, 2003, 2005), 1, 0, 3),
])
def test_diff_pass_rule_and_straddles(tmp_path, capsys, case, change, rc,
                                      straddles, hard):
    _block_files(tmp_path, change)
    assert dayrun.main(["--phase", "diff", *SMALL, *_files(tmp_path)]) == rc
    oracle = json.loads((tmp_path / "day.json").read_text())["oracle"]
    assert oracle["pass"] == (rc == 0)
    assert oracle["chip_straddles"] == straddles
    assert oracle["hard_mismatches"] == hard
    assert oracle["compared_values"] == 2 * 2 * 100000 * 2
    assert oracle["oracle_wall_s"] == 1.5
    assert [d["epochs"] for d in oracle["detail"]] == [[0, 2], [3, 5]]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "oracle_pass"] == (rc == 0)


def test_diff_refuses_other_block_geometry(tmp_path):
    _block_files(tmp_path)
    (tmp_path / "day.json").write_text(json.dumps(
        {"sampled_blocks": [[0, 2], [4, 6]]}))
    with pytest.raises(ValueError, match="different block geometry"):
        dayrun.main(["--phase", "diff", *SMALL, *_files(tmp_path)])


def test_oracle_phases_need_the_reference(tmp_path, capsys, monkeypatch):
    absent = tmp_path / "no-reference"
    monkeypatch.setattr(deepcheck, "REF", absent)
    monkeypatch.setattr(dayrun, "REF", absent)
    for main, argv in (
            (dayrun.main, ["--phase", "oracle", *SMALL, *_files(tmp_path)]),
            (deepcheck.main, ["--duration", "1", "--block-epochs", "2"]),
            (deepcheck.main, ["--reference", str(absent)])):
        assert main(argv) == 1
        err = capsys.readouterr().err
        assert f"ERROR: the C reference is not in {absent}" in err
        assert "gpssim.c" in err
    assert not (tmp_path / "oracle.npz").exists()
    with pytest.raises(deepcheck.ReferenceMissing):
        deepcheck.build_oracle(tmp_path)


def test_synth_needs_a_card_or_device_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert dayrun.main([*SMALL, *_files(tmp_path)]) == 1
    assert "ERROR: CUDA device 'cuda' is not available; --device cpu runs " \
        "the plain version" in capsys.readouterr().err
    assert not (tmp_path / "day.json").exists()
    with pytest.raises(RuntimeError, match="not available"):
        dayrun.synth_day(deepcheck.static_config(1.0e6, 1.0), device="cuda")


def test_only_blocks_names_a_sampled_block(tmp_path, capsys):
    with pytest.raises(ValueError, match="no sampled block starts at"):
        dayrun.synth_day(deepcheck.static_config(1.0e6, 1.0),
                         block_epochs=2, filler_blocks=1, device="cpu",
                         only_blocks=[1], log=lambda s: None)
    assert dayrun.main(["--device", "cpu", *SMALL, "--only-blocks", "1",
                        *_files(tmp_path)]) == 1
    assert capsys.readouterr().err.startswith(
        "ERROR: no sampled block starts at epochs [1]")
    assert list(tmp_path.iterdir()) == []


def test_reference_default_lies_inside_the_checkout(monkeypatch):
    """Without --reference or $GPS_SDR_SIM_REFERENCE the oracle's sources
    are looked for in reference/ of this checkout, never beside it."""
    monkeypatch.delenv("GPS_SDR_SIM_REFERENCE", raising=False)
    code = ("from gps_sdr_sim_tpu_torch.tools import deepcheck; "
            "print(deepcheck.REF)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == str(ROOT / "reference")


def test_block_slices_and_merge():
    blocks = [(287993, 288013), (288000, 288020)]
    assert dayrun.block_slices(blocks, 287700, 288000) == [
        (287993, 293, 300)]
    assert dayrun.block_slices(blocks, 288000, 288300) == [
        (287993, 0, 13), (288000, 0, 20)]
    assert dayrun._merge(blocks + [(0, 20)]) == [(0, 20), (287993, 288020)]


def test_spot_check_writes_only_where_told(tmp_path):
    """The defaults lie under the ignored build/; with paths given, nothing
    else is written. On the CPU no kernel is launched."""
    before = {p.name for p in ROOT.iterdir()}
    launches = dict(synth.launch_counts)
    assert dayrun.main(["--device", "cpu", *SMALL, "--only-blocks", "0,3",
                        *_files(tmp_path)]) == 0
    assert {p.name for p in ROOT.iterdir()} == before
    stats = json.loads((tmp_path / "day.json").read_text())
    assert stats["epochs_synthesized"] == 4
    assert set(np.load(tmp_path / "blocks.npz").files) == {"b0", "b3"}
    assert dayrun.BUILD == ROOT / "build"
    assert synth.launch_counts == launches
