"""The port's benchmark (gps_sdr_sim_tpu_torch/tools/bench.py) on the CPU.

- The synthesis pass against root bench.py: for torch, closed and
  torch-sharded (a 2x2 mesh of the CPU device) and each format, the port's
  synthesis pass over the canonical scenario cut to 0.3 s in 2-epoch
  batches gives exactly the (sum, nonzero) that root bench.py --impl xla
  --cpu prints for the same run;
- the end-to-end pass: what run_simulation writes gives the same sums;
- the goldens: golden_checksums() reads the committed file and the legacy
  forms exactly as root bench.py's _golden_checksums() does;
- the gate: a golden that differs, a batch without a nonzero sample,
  end-to-end bytes that differ or a later synthesis pass that differs from
  the warm-up exit 1 with CHECKSUM MISMATCH; a short run is not held to
  the golden; the exact gate through main() on a canonical duration cut to
  0.3 s;
- the JSON line: one line on stdout with every field, from a process in
  which any import of JAX, the JAX package or a root tool raises; the
  roofline's peak counts every distinct device of the mesh;
- the refusals: CUDA impls under --cpu, no card without --cpu.

Every comparison is exact: the checksums are integer sums."""

import ast
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
from gps_sdr_sim_tpu_torch.ops.quantize import wrap_int32
from gps_sdr_sim_tpu_torch.parallel import make_mesh
from gps_sdr_sim_tpu_torch.runner import iter_seg_batches
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools import bench

CPU = torch.device("cpu")
DURATION, BATCH = 0.3, 2
SHORT = ["--cpu", "--duration", str(DURATION), "--batch-epochs", str(BATCH)]
IMPLS = ("torch", "closed", "torch-sharded")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch on one thread here: the suite runs several test processes
    on a few cores, and these small ops stall on contended intra-op
    threads (ROADMAP C3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_sums():
    """{fmt: (sum, nonzero)} of root bench.py's xla run at 0.3 s, read off
    its stderr progress lines."""
    env = dict(os.environ, GPS_SDR_SIM_TPU_NO_CACHE="1", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench.py"), "--impl", "xla", "--cpu",
         "--duration", str(DURATION), "--batch-epochs", str(BATCH),
         "--sessions", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    found = re.findall(r"^sc(\d+) warmup: .* checksum=(-?\d+), "
                       r"nonzero=(\d+)$", proc.stderr, re.M)
    assert len(found) == 3, proc.stderr[-4000:]
    return {int(f): (int(s), int(z)) for f, s, z in found}


@pytest.fixture(scope="module")
def scenarios():
    return {fmt: bench.canonical_scenario(fmt, DURATION)
            for fmt in bench.FORMATS}


def _mesh(impl):
    return make_mesh(2, 2, [CPU] * 4) if impl.endswith("-sharded") else None


@pytest.fixture
def root_bench(monkeypatch, tmp_path):
    """Root bench.py as a module, reading its golden under tmp_path, and
    the port's bench pointed at the same file."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    golden = tmp_path / "tests" / "golden" / "bench_checksum.txt"
    golden.parent.mkdir(parents=True)
    monkeypatch.setattr(module, "_ROOT", tmp_path)
    monkeypatch.setattr(bench, "GOLDEN_FILE", golden)
    return module, golden


# ---------------------------------------------------------------------------
# The two passes against root bench.py.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", bench.FORMATS)
@pytest.mark.parametrize("impl", IMPLS)
def test_synthesis_pass_matches_root_bench(jax_sums, scenarios, impl, fmt):
    res = bench.synthesis_pass(scenarios[fmt], BATCH, impl, CPU, _mesh(impl))
    assert (res.checksum, res.nonzero) == jax_sums[fmt]
    assert res.min_batch_nonzero > 0 and res.wall > 0


@pytest.mark.parametrize("fmt", bench.FORMATS)
@pytest.mark.parametrize("impl", IMPLS)
def test_end_to_end_pass_matches_synthesis_pass(jax_sums, scenarios, impl,
                                                fmt):
    scn = scenarios[fmt]
    sink = bench.ChecksumSink(fmt)
    wall, stats = bench.end_to_end_pass(scn, sink, BATCH, impl, CPU,
                                        _mesh(impl))
    res = bench.synthesis_pass(scn, BATCH, impl, CPU, _mesh(impl))
    assert (wrap_int32(sink.sum), sink.nonzero) == (
        res.checksum, res.nonzero) == jax_sums[fmt]
    assert wall > 0 and stats.total_samples == scn.total_samples
    assert bench.gate(fmt, res, sink, None, canonical=False) is None


def test_synthesis_pass_is_batch_invariant(jax_sums, scenarios):
    """One-epoch batches: two batches, the least nonzero count of the two
    below the total."""
    res = bench.synthesis_pass(scenarios[16], 1, "torch", CPU)
    assert (res.checksum, res.nonzero) == jax_sums[16]
    assert 0 < res.min_batch_nonzero < res.nonzero


# ---------------------------------------------------------------------------
# Goldens.
# ---------------------------------------------------------------------------


def test_root_bench_imports_no_jax_at_module_level():
    tree = ast.parse((ROOT / "bench.py").read_text())
    names = [a.name for n in tree.body if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "gps_sdr_sim_tpu")]


@pytest.mark.parametrize("text", [
    None,  # the committed file
    "36897464\n",
    "16 36897464\n8 -728726826\n1 -943099421\n",
    "16 36897464 1557786658\n\n8 -728726826\n",
    "",
])
def test_golden_checksums_match_root_bench(root_bench, text):
    module, golden = root_bench
    committed = ROOT / "tests" / "golden" / "bench_checksum.txt"
    golden.write_text(committed.read_text() if text is None else text)
    assert bench.golden_checksums() == module._golden_checksums()
    if text is None:
        assert bench.golden_checksums() == {
            16: (36897464, 1557786658), 8: (-728726826, 1532373525),
            1: (-943099421, 188395662)}


def test_golden_checksums_without_a_file(root_bench):
    module, _ = root_bench
    assert bench.golden_checksums() == module._golden_checksums() == {}


# ---------------------------------------------------------------------------
# The gate.
# ---------------------------------------------------------------------------


def _sink(fmt, total, nonzero):
    sink = bench.ChecksumSink(fmt)
    sink.sum, sink.nonzero = total, nonzero
    return sink


GOOD = bench.PassResult(1.0, 36897464, 1557786658, 5)


@pytest.mark.parametrize("result, sink, golden", [
    (GOOD, _sink(16, 36897464, 1557786658), (36897465, 1557786658)),
    (GOOD, _sink(16, 36897464, 1557786658), (36897464, 1557786657)),
    (bench.PassResult(1.0, 36897464, 1557786658, 0),
     _sink(16, 36897464, 1557786658), (36897464, 1557786658)),
    (GOOD, _sink(16, 36897464 + 2 ** 32 + 1, 1557786658),
     (36897464, 1557786658)),
    (GOOD, _sink(16, 36897464, 1557786658), None),
], ids=["sum", "nonzero", "empty batch", "end-to-end", "no golden"])
def test_gate_refuses(result, sink, golden):
    with pytest.raises(bench.ChecksumMismatch,
                       match=r"^sc16 CHECKSUM MISMATCH: got sum=36897464 "):
        bench.gate(16, result, sink, golden, canonical=True)


def test_gate_passes():
    # The end-to-end sum wraps mod 2^32 like the golden's.
    sink = _sink(16, 36897464 - 2 ** 32, 1557786658)
    assert bench.gate(16, GOOD, sink, (36897464, 1557786658), True) is True
    assert bench.gate(16, GOOD, sink, (36897464, None), True) is True
    # A short run is not held to the golden, but still to the other checks.
    assert bench.gate(16, GOOD, sink, (1, 2), canonical=False) is None
    with pytest.raises(bench.ChecksumMismatch, match="no nonzero"):
        bench.gate(16, bench.PassResult(1.0, 36897464, 1557786658, 0), sink,
                   None, canonical=False)


def test_the_exact_gate_through_main(root_bench, jax_sums, monkeypatch,
                                    capsys):
    """With the canonical duration cut to 0.3 s and a golden of the JAX
    bench's sums: a run is verified in every format, and one changed golden
    makes the run exit 1 with CHECKSUM MISMATCH and print no JSON line."""
    _, golden = root_bench
    monkeypatch.setattr(bench, "CANONICAL_DURATION", DURATION)
    golden.write_text("".join(f"{fmt} {s} {z}\n"
                              for fmt, (s, z) in jax_sums.items()))
    assert bench.main(SHORT + ["--impl", "torch"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["checksum_verified"] is True
    assert all(f["checksum_verified"] is True
               for f in line["formats"].values())

    golden.write_text(golden.read_text().replace(
        f"8 {jax_sums[8][0]} ", f"8 {jax_sums[8][0] + 1} "))
    assert bench.main(SHORT + ["--impl", "torch"]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert (f"sc08 CHECKSUM MISMATCH: got sum={jax_sums[8][0]} "
            f"nonzero={jax_sums[8][1]}") in err


@pytest.mark.parametrize("field", ["checksum", "nonzero",
                                   "min_batch_nonzero"])
def test_check_repeat_refuses(field):
    bad = dataclasses.replace(GOOD, **{field: getattr(GOOD, field) - 1})
    with pytest.raises(bench.ChecksumMismatch,
                       match=r"^sc08 CHECKSUM MISMATCH: measure2 got "):
        bench.check_repeat(8, "measure2", GOOD, bad)
    # The wall is not compared.
    bench.check_repeat(8, "measure2", GOOD,
                       dataclasses.replace(GOOD, wall=2.0))


# Synthesis passes in a run of main(): warm-up and 3 / 2 / 2 measure passes
# of SC16 / SC08 / SC01, then two interleaved 16/8/1 rounds.
PASSES = sum(n + 1 for n in bench.MEASURE_PASSES.values()) + 2 * 3


@pytest.mark.parametrize("wrong, label", [
    (2, "sc16 CHECKSUM MISMATCH: measure1 got "),
    (7, "sc08 CHECKSUM MISMATCH: measure2 got "),
    (PASSES, "sc01 CHECKSUM MISMATCH: interleaved round 2 got "),
])
def test_a_wrong_later_pass_exits_1(monkeypatch, capsys, wrong, label):
    """A synthesis pass after the warm-up that gives other sums (here one
    more in its sum) makes main() exit 1 with CHECKSUM MISMATCH and no
    JSON line, in a timed pass as in an interleaved round."""
    calls = []
    synthesis_pass = bench.synthesis_pass

    def planted(*args, **kwargs):
        res = synthesis_pass(*args, **kwargs)
        calls.append(res)
        if len(calls) == wrong:
            res = dataclasses.replace(res, checksum=res.checksum + 1)
        return res

    monkeypatch.setattr(bench, "synthesis_pass", planted)
    assert bench.main(SHORT + ["--impl", "torch"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and label in err
    assert len(calls) == wrong


# ---------------------------------------------------------------------------
# The JSON line and the refusals.
# ---------------------------------------------------------------------------

_NO_JAX = r"""
import sys
BLOCKED = ("jax", "gps_sdr_sim_tpu", "tools", "__graft_entry__", "bench",
           "bench_scaling", "deepcheck", "dayrun")
for name in BLOCKED:
    sys.modules[name] = None
from gps_sdr_sim_tpu_torch.tools.bench import main
rc = main(sys.argv[1:])
assert not any(m.split(".")[0] in BLOCKED
               for m in sys.modules if sys.modules[m] is not None), \
    "jax, gps_sdr_sim_tpu or a root tool was imported"
sys.exit(rc)
"""

FIELDS = {
    "metric", "value", "unit",
    "synthesis_realtime_factor_circle300s_2.6msps_sc16", "impl",
    "nav_gather", "batch_epochs", "duration_s", "card", "vs_baseline",
    "checksum_verified", "started_utc", "devices", "formats", "avg_channels_with_gain", "ops_per_chan_sample",
    "ops_per_quantized_sample", "effective_teraops", "peak_teraops",
    "roofline_share"}
PASS_FIELDS = {"realtime_factor", "vs_baseline", "measure_walls_s",
               "interleaved_rt"}
FORMAT_FIELDS = PASS_FIELDS | {
    "synthesis", "checksum", "nonzero", "min_batch_nonzero",
    "checksum_verified", "plan_s", "fetch_s", "write_s"}


def _keys(obj):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield k
            yield from _keys(v)


def test_json_line(jax_sums, scenarios):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "--impl", "torch"] + SHORT,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert FIELDS <= set(line)
    assert not [k for k in _keys(line) if "vpu" in k or "mfu" in k]
    assert line["metric"] == "realtime_factor_circle300s_2.6msps_sc16"
    assert line["unit"] == "x_realtime" and line["card"] == "cpu"
    assert (line["impl"], line["nav_gather"], line["batch_epochs"],
            line["duration_s"]) == ("torch", False, BATCH, DURATION)
    assert line["checksum_verified"] is None  # not the canonical duration
    assert line["devices"] == 1
    sc16 = line["formats"]["sc16"]
    scn = scenarios[16]
    assert line["value"] == sc16["realtime_factor"] == (
        scn.total_samples / scn.samp_freq / min(sc16["measure_walls_s"]))
    assert line["vs_baseline"] == line["value"] / 4.4
    assert line["peak_teraops"] is None and line["roofline_share"] is None
    assert (line["ops_per_chan_sample"],
            line["ops_per_quantized_sample"]) == (14, 4)
    assert set(line["formats"]) == {"sc16", "sc08", "sc01"}
    for fmt in bench.FORMATS:
        f = line["formats"][f"sc{fmt:02d}"]
        assert set(f) == FORMAT_FIELDS and set(f["synthesis"]) == PASS_FIELDS
        assert (f["checksum"], f["nonzero"]) == jax_sums[fmt]
        assert f["min_batch_nonzero"] == f["nonzero"]  # one batch
        assert f["checksum_verified"] is None
        assert len(f["measure_walls_s"]) == bench.MEASURE_PASSES[fmt]
        assert f["interleaved_rt"] > 0 and f["synthesis"]["interleaved_rt"] > 0
    # The mean channels with gain of the plan that the passes ran.
    scn = scenarios[16]
    pairs = sum(int((plan_epochs(seg, e, e1, scn.delt).gain != 0).sum())
                for seg, e, e1 in iter_seg_batches(scn, 0,
                                                   scn.n_output_epochs, 1))
    assert line["avg_channels_with_gain"] == pairs / scn.n_output_epochs
    rt = line["synthesis_realtime_factor_circle300s_2.6msps_sc16"]
    assert line["effective_teraops"] == pytest.approx(
        rt * 2.6e6 * (pairs / scn.n_output_epochs * 14 + 4) / 1e12,
        rel=1e-12)
    assert re.search(r"^sc16 measure1: synthesis .* checksum=-?\d+, "
                     r"nonzero=\d+; end-to-end ", proc.stderr, re.M)


@pytest.mark.parametrize("argv, error", [
    (["--cpu", "--impl", "cuda"], "--impl cuda runs the CUDA kernel"),
    (["--cpu", "--impl", "cuda-sharded"], "--impl cuda-sharded runs the"),
    (["--impl", "torch"], "CUDA device 'cuda' is not available"),
    (["--impl", "closed"], "CUDA device 'cuda' is not available"),
    (["--cpu", "--impl", "torch", "--batch-epochs", "0"],
     "batch_epochs must be at least 1"),
])
def test_refusals(monkeypatch, capsys, argv, error):
    """Each exits 1 with one ERROR line before anything runs: no scenario,
    no JSON line. Without --cpu the machine has no card (here by
    construction), and the bench does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "canonical_scenario", None)
    assert bench.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert err.startswith(f"ERROR: {error}") and err.count("\n") == 1


@pytest.mark.parametrize("devices, distinct", [
    ([CPU] * 4, 1),
    ([torch.device("cuda", i) for i in range(4)], 4),
    ([torch.device("cuda", i) for i in (0, 1, 0, 1)], 2),
], ids=["2x2 of the CPU", "2x2 of four cards", "2x2 of two cards"])
def test_roofline_counts_every_device_of_the_mesh(devices, distinct):
    """The peak is the published issue rate times the mesh's distinct
    devices (the mesh is only described here: no card is touched)."""
    mesh = make_mesh(2, 2, devices)
    assert bench.mesh_devices(mesh) == list(dict.fromkeys(devices))
    assert len(bench.mesh_devices(mesh)) == distinct
    peak, share = bench.roofline(2e12, distinct, cpu=False)
    assert peak == bench.card.ISSUE_PER_S * distinct
    assert share == 2e12 / peak
    assert bench.roofline(2e12, distinct, cpu=True) == (None, None)
    assert bench.mesh_devices(None) == []
