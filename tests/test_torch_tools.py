"""The port's tools and the CLI's --profile on the CPU.

- tools/vpu_peak: the plain version equals the Pallas interpreter run of
  tools/vpu_peak.py::_make_kernel in all five cases, word for word; the
  SASS loop reader finds each case's round loop;
- tools/ab_kernel: the --cpu plumbing at a tiny batch, and the refusal of
  the JAX harness's TPU-only variants;
- --profile: a trace file appears, the bytes equal a run without the flag,
  and stderr's last line equals the JAX CLI's;
- tools/bench_scaling: one row per mesh with the device fields (closed on
  meshes that repeat the CPU device), the refusal of the CUDA impls off a
  card, and a 1,2-process --multihost sweep on the CPU;
- utils/playerfmt: the cases of tests/test_tools.py against the port's
  copy of the ctypes binding (1-bit expansion of the port's SC01 packing,
  rescaling, the SDR option clamps);
- tools/uhd_player: --sink writes the JAX tool's bytes in every format;
- the CLI's -o - piped into tools/gps-sdr-player -f - gives what the
  player gives on the same capture read from a file."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gps_sdr_sim_tpu.cli import main as jax_main
from gps_sdr_sim_tpu_torch.cli import main
from gps_sdr_sim_tpu.utils import playerfmt as jax_playerfmt
from gps_sdr_sim_tpu_torch.ops import synth, synth_cuda
from gps_sdr_sim_tpu_torch.ops.quantize import pack_sc01
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools import (
    ab_kernel,
    bench_scaling,
    card,
    uhd_player,
    vpu_peak,
)
from gps_sdr_sim_tpu_torch.utils import playerfmt

from test_torch_runner import STATIC


@pytest.fixture(scope="module")
def jax_vpu_peak():
    """tools/vpu_peak.py as a module; it enables a compilation cache at
    import unless told not to."""
    before = os.environ.get("GPS_SDR_SIM_TPU_NO_CACHE")
    os.environ["GPS_SDR_SIM_TPU_NO_CACHE"] = "1"
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_vpu_peak", ROOT / "tools" / "vpu_peak.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if before is None:
            del os.environ["GPS_SDR_SIM_TPU_NO_CACHE"]
        else:
            os.environ["GPS_SDR_SIM_TPU_NO_CACHE"] = before
    return module


@pytest.mark.parametrize("case", sorted(vpu_peak.CASES))
def test_vpu_peak_plain_matches_pallas_interpret(jax_vpu_peak, case):
    tiles, rounds = 2, 3
    _, alu, gathers, extra, n_extra = vpu_peak.CASES[case]
    seed, table = vpu_peak.inputs("cpu")
    kernel = jax_vpu_peak._make_kernel(rounds, gathers, alu, extra, n_extra)
    fn = pl.pallas_call(
        kernel, grid=(tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((16, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((tiles * 16, 128), jnp.int32),
        interpret=True)
    want = np.asarray(fn(jnp.asarray(seed.numpy()),
                         jnp.asarray(table.numpy().reshape(1, 128))))
    got = vpu_peak.vpu_peak(seed, table, tiles, rounds, case)
    assert got.dtype == torch.int32 and tuple(got.shape) == (32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vpu_peak_inputs_match_jax_tool(jax_vpu_peak):
    """The seed block and table of tools/vpu_peak.py:_run_case."""
    seed, table = vpu_peak.inputs("cpu")
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(seed.numpy(), rng.integers(
        0, 1 << 20, size=(jax_vpu_peak.SLAB, jax_vpu_peak.LANES),
        dtype=np.int32))
    np.testing.assert_array_equal(table.numpy(), np.arange(128))
    assert vpu_peak.N_ACC == jax_vpu_peak.N_ACC


def _sass_function(name, loop_body):
    """A kernel in `cuobjdump -sass`'s layout: one instruction, a loop of
    `loop_body` plus a compare and its backward branch, a NOP, EXIT, and
    the trailing branch to itself."""
    ops = ["MOV R1, c[0x0][0x28]", *loop_body,
           "ISETP.NE.AND P0, PT, R5, RZ, PT", "@P0 BRA 0x10", "NOP", "EXIT"]
    ops.append(f"BRA {hex(16 * len(ops))}")
    lines = [f"        Function : {name}"] + [
        f"        /*{16 * i:04x}*/                   {op} ;"
        for i, op in enumerate(ops)]
    return "\n".join(lines) + "\n"


def test_sass_loop_reader():
    """A backward branch closes a loop (predicates stripped, NOPs dropped);
    the trailing self-branch is not a loop; each vpu_peak case maps to its
    instantiation's round loop."""
    body = ["IADD3 R2, R2, R3, RZ", "NOP",
            "LOP3.LUT R4, R4, R2, RZ, 0x3c, !PT"]
    loops = synth_cuda.sass_loops(_sass_function("k", body))
    assert loops == {"k": [["IADD3", "LOP3.LUT", "ISETP.NE.AND", "BRA"]]}
    names = {"alu": "ILi32ELi0ELi0ELi0E", "gather": "ILi32ELi4ELi0ELi0E",
             "mix": "ILi38ELi2ELi0ELi0E", "imul": "ILi32ELi0ELi1ELi4E",
             "f32rt": "ILi32ELi0ELi2ELi4E"}
    text = "".join(_sass_function(
        f"_ZN12_GLOBAL__N_115vpu_peak_kernel{args}EvPKiS1_Piii",
        body * (k + 1)) for k, args in enumerate(names.values()))
    counts = vpu_peak.round_instructions(synth_cuda.sass_loops(text))
    assert counts == {name: 2 * k + 4 for k, name in enumerate(names)}

    # The synthesis kernels: a prologue loop with few shared loads, then the
    # rolled channel loop, which loads the channel's state and then, per
    # sample of the thread, a sign word and a trig pair; the count is its
    # length over the samples one trip covers.
    per_sample = ["IADD3 R8, P0, R8, R9, RZ", "IADD3.X R10, R10, R11, RZ",
                  "SHF.R.U32.HI R12, RZ, 0x5, R10", "LDS R13, [R12]",
                  "SHF.R.W.U32 R13, R13, R10, R13",
                  "LOP3.LUT R14, R15, 0x1, R13, 0xe2, !PT",
                  "LDS.64 R16, [R14]", "IMAD R20, R5, R16, R20"]
    wire = {(0, 16): "synth_wire/16", (0, 8): "synth_wire/8",
            (0, 1): "synth_wire/1", (1, 0): "synth_wire_planes",
            (2, 0): "synth_wire_raw"}
    kernels = {}
    for (mode, fmt), key in wire.items():
        for nav in (0, 1):
            name = (f"_ZN12_GLOBAL__N_117synth_wire_kernelILi{mode}ELi{fmt}"
                    f"ELb{nav}EEEvPKiS2_S2_PiS3_ii")
            kernels[name] = synth_cuda.instantiation_key(name)
    for mode, key in ((1, "synth_rows_planes"), (2, "synth_rows_raw")):
        kernels[f"_ZN12_GLOBAL__N_117synth_rows_kernelILi{mode}EEEvPKiS2_S2_"
                f"PiS3_i"] = key
    assert sorted(kernels.values()) == sorted(
        synth_cuda.all_instantiation_keys())
    text, want = "", {}
    for k, (name, key) in enumerate(kernels.items()):
        setup = ["LDS.64 R2, [UR4]"] * (k + 1)
        prologue = ["LDS R3, [R4]", "STS [R5], R3"]
        ops = ["MOV R1, c[0x0][0x28]", *prologue, "@P1 BRA 0x10",
               *setup, *per_sample * synth_cuda.SAMPLES_PER_TRIP,
               "ISETP.NE.AND P0, PT, R5, RZ, PT"]
        ops += [f"@P0 BRA {hex(16 * 4)}", "EXIT"]
        ops.append(f"BRA {hex(16 * len(ops))}")
        text += "\n".join([f"        Function : {name}"] + [
            f"        /*{16 * i:04x}*/                   {op} ;"
            for i, op in enumerate(ops)]) + "\n"
        want[key] = (len(setup) + 2 + len(per_sample)
                     * synth_cuda.SAMPLES_PER_TRIP) / synth_cuda.SAMPLES_PER_TRIP
    assert synth_cuda.channel_loop_instructions(
        synth_cuda.sass_loops(text)) == want
    with pytest.raises(AssertionError, match="SASS holds kernels"):
        synth_cuda.channel_loop_instructions(synth_cuda.sass_loops(
            text.split("        Function : ")[0] + "".join(
                "        Function : " + f for f in
                text.split("        Function : ")[1:-1])))


def test_ptxas_usage_reader():
    """Registers, shared memory and spills of each kernel from -Xptxas -v,
    keyed by the synthesis instantiation they belong to."""
    name = ("_ZN40_GLOBAL__N__9e8a86ad_8_synth_cu_1b10364517synth_wire_kernel"
            "ILi2ELi0ELb1EEEvPKiS2_S2_PiS3_ii")
    text = (
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 72 registers, used 1 barriers, 17540 bytes "
        "smem\n"
        "ptxas info    : Compile time = 77.374 ms\n")
    usage = synth_cuda.ptxas_usage(text)
    assert usage == {name: {"registers": 72, "smem_bytes": 17540,
                            "spill_stores": 8, "spill_loads": 4}}
    assert synth_cuda.instantiation_key(name) == "synth_wire_raw_nav"
    assert synth_cuda.instantiation_key("vpu_peak_kernel") is None


def test_vpu_peak_refuses_bad_operands():
    seed, table = vpu_peak.inputs("cpu")
    with pytest.raises(ValueError, match="case must be one of"):
        vpu_peak.vpu_peak(seed, table, 1, 1, "tree")
    with pytest.raises(TypeError):
        vpu_peak.vpu_peak(seed.long(), table, 1, 1, "alu")
    with pytest.raises(ValueError, match="measures a CUDA device"):
        vpu_peak.measure("cpu")


def test_ab_kernel_cpu_plumbing(tmp_path, capsys):
    out = tmp_path / "ab.json"
    assert ab_kernel.main(["--b", "nav_gather", "--cpu", "--batch-epochs",
                           "1", "--passes", "1", "--reps", "2", "--fmt", "1",
                           "--json", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out.read_text())
    assert line["bit_equal"] and line["backend"] == "cpu"
    assert line["a"] == "default" and line["b"] == "nav_gather"
    assert sorted(line["reps_s"]) == ["default", "nav_gather"]
    assert all(len(v) == 2 for v in line["reps_s"].values())
    assert line["b_over_a"] == line["best_s"]["nav_gather"] / \
        line["best_s"]["default"]


@pytest.mark.parametrize("tool", ["dayrun", "deepcheck", "bench_scaling"])
def test_tools_refuse_rates_below_the_cli_floor(capsys, tool):
    """A --samp-freq below the CLI's 1 Msps floor is an ERROR line and exit
    1 before any work: lower rates leave the CUDA kernel's domain of code
    steps, so a card would trap on them. The floor itself is taken."""
    mod = importlib.import_module(f"gps_sdr_sim_tpu_torch.tools.{tool}")
    assert mod.main(["--samp-freq", "999999"]) == 1
    assert capsys.readouterr().err == (
        "ERROR: --samp-freq must be at least 1e+06 (the CLI's floor).\n")
    assert synth.refuse_samp_freq(synth.MIN_SAMP_FREQ) is None


def test_time_ms_on_the_host():
    """The shared timer: one warm-up call, then the best of `reps`."""
    calls = []
    ms = card.time_ms(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 4 and 0 <= ms < 1e3
    card.time_ms(lambda: calls.append(1), 2, "cpu", warm=False)
    assert len(calls) == 6


def test_ab_compare_refuses_to_time_unequal_variants():
    out = ab_kernel.compare({"a": lambda: torch.zeros(3),
                             "b": lambda: torch.ones(3)}, device="cpu")
    assert out == {"bit_equal": False}


@pytest.mark.parametrize("variant", ab_kernel.TPU_ONLY)
def test_ab_kernel_refuses_tpu_only_variants(capsys, variant):
    assert ab_kernel.main(["--b", variant, "--cpu", "--batch-epochs",
                           "1"]) == 2
    assert "lowering choice of the TPU kernel" in capsys.readouterr().err


def test_profile_writes_trace(tmp_path, capsys):
    """--profile DIR on the CPU: a Chrome trace of the run lands in DIR,
    the output bytes are those of a run without the flag, and stderr ends
    with the JAX CLI's line."""
    prof = tmp_path / "prof"
    run = STATIC + ["--impl", "torch", "--device", "cpu"]
    assert main(run + ["-o", str(tmp_path / "plain.bin")]) == 0
    capsys.readouterr()
    assert main(run + ["-o", str(tmp_path / "prof.bin"), "--profile",
                       str(prof)]) == 0
    err = capsys.readouterr().err.splitlines()
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert (tmp_path / "prof.bin").read_bytes() == \
        (tmp_path / "plain.bin").read_bytes()
    assert jax_main(STATIC + ["--impl", "xla", "-o",
                              str(tmp_path / "jax.bin"), "--profile",
                              str(prof)]) == 0
    assert err[-1] == capsys.readouterr().err.splitlines()[-1] == \
        f"profiler trace written to {prof}"


# ---------------------------------------------------------------------------
# tools/bench_scaling.
# ---------------------------------------------------------------------------

_TINY = ["--epochs-per-device", "1", "--samp-freq", "1e6", "--repeats", "1"]


@pytest.fixture
def one_torch_thread(monkeypatch):
    """torch on one thread, here and in the processes a test starts: the
    suite runs several test processes on a few cores, and these small ops
    stall on contended intra-op threads (ROADMAP C3)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


@pytest.mark.usefixtures("one_torch_thread")
def test_bench_scaling_closed_on_the_cpu(capsys):
    """Meshes of 1, 2 and 4 entries that repeat the CPU device, a chan
    axis of 2 from 2 entries on: one JSON row each."""
    assert bench_scaling.main(["--device", "cpu", "--impl", "closed",
                               "--repeat-devices", "1,2,4", "--chan-axis",
                               "2"] + _TINY) == 0
    rows = _rows(capsys)
    assert [r["mesh"] for r in rows] == [
        [["time", 1], ["chan", 1]], [["time", 1], ["chan", 2]],
        [["time", 2], ["chan", 2]]]
    assert [r["devices"] for r in rows] == [r["epochs"] for r in rows] == \
        [1, 2, 4]
    assert rows[0]["efficiency_vs_1dev"] == 1.0
    for r in rows:
        assert r["metric"] == "scaling_samples_per_sec" and r["value"] > 0
        assert r["distinct_devices"] == 1
        assert (r["device_type"], r["device_name"], r["device_count"],
                r["power_limit"]) == ("cpu", None, 1, None)


@pytest.mark.parametrize("impl", ["cuda", "cuda-wire"])
def test_bench_scaling_refuses_cuda_impls_on_the_cpu(impl):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        bench_scaling.main(["--device", "cpu", "--impl", impl] + _TINY)


def test_bench_scaling_exits_non_zero_without_a_card():
    """As a program: --impl cuda on the CPU, and --impl closed on the
    default cuda device of a machine that has none, exit non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for extra in (["--device", "cpu", "--impl", "cuda"],
                  ["--impl", "closed"]):
        proc = subprocess.run(
            [sys.executable, "-m", "gps_sdr_sim_tpu_torch.tools.bench_scaling",
             *extra, *_TINY], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""
        assert ("needs a CUDA device" in proc.stderr
                or "no CUDA device is available" in proc.stderr)


@pytest.mark.usefixtures("one_torch_thread")
def test_bench_scaling_multihost_on_the_cpu(capsys):
    assert bench_scaling.main(["--multihost", "1,2", "--device", "cpu",
                               "--duration", "0.3"]) == 0
    rows = _rows(capsys)
    assert [r["processes"] for r in rows] == [1, 2]
    for r in rows:
        assert r["metric"] == "multihost_scaling_samples_per_sec"
        assert r["impl"] == "closed" and r["device_type"] == "cpu"
        assert 0 < r["synth_wall_s"] < r["wall_s"]
    assert rows[0]["efficiency_vs_1proc"] == 1.0


# ---------------------------------------------------------------------------
# utils/playerfmt.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_playerfmt(tmp_path_factory):
    """The port's binding on a library built from tools/'s sources into a
    directory of this module's own (tests/test_tools.py builds tools/ in
    place, perhaps at the same time)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler available")
    lib = tmp_path_factory.mktemp("playerfmt") / "libplayerfmt.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-pthread", "-shared",
                    "-o", str(lib), "playerfmt.cpp", "sdr_backends.cpp",
                    "bytering.cpp"], cwd=ROOT / "tools", check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(playerfmt, "_LIB_PATH", lib)
        mp.setattr(playerfmt, "_lib", None)
        yield playerfmt


def test_playerfmt_binds_the_tools_library():
    assert playerfmt._LIB_PATH == jax_playerfmt._LIB_PATH == \
        ROOT / "tools" / "libplayerfmt.so"


def test_playerfmt_expand_1bit_roundtrip(port_playerfmt):
    """The C++ 1-bit expansion inverts the port's SC01 packing."""
    rng = np.random.default_rng(7)
    iq = rng.integers(-2000, 2000, size=(1, 256, 2), dtype=np.int16)
    iq[iq == 0] = 1  # sign(0) packs as negative; keep the test unambiguous
    packed = pack_sc01(torch.from_numpy(iq)).numpy().reshape(-1)
    expanded = port_playerfmt.expand_1bit(packed, amplitude=1000)
    expect = np.where(iq.reshape(-1) > 0, 1000, -1000).astype(np.int16)
    np.testing.assert_array_equal(expanded, expect)


def test_playerfmt_rescale_matches_generator(port_playerfmt):
    v = np.array([-32768, -4096, -17, -1, 0, 1, 15, 4095, 32767],
                 dtype=np.int16)
    np.testing.assert_array_equal(port_playerfmt.shift16(v, 4), v >> 4)
    np.testing.assert_array_equal(port_playerfmt.narrow16to8(v, 4),
                                  (v >> 4).astype(np.int8))
    b = np.array([-128, -1, 0, 1, 127], dtype=np.int8)
    np.testing.assert_array_equal(port_playerfmt.widen8(b, 4),
                                  b.astype(np.int16) << 4)


def test_playerfmt_sdr_option_clamps(port_playerfmt):
    pf = port_playerfmt
    assert pf.lime_clamp_gain(-0.5) == 0.0
    assert pf.lime_clamp_gain(0.25) == 0.25
    assert pf.lime_clamp_gain(1.5) == 1.0
    assert pf.lime_clamp_dynamic(4096) == 2047
    assert pf.lime_clamp_dynamic(1000) == 1000
    assert pf.lime_clamp_channel(1, 2) == 1
    assert pf.lime_clamp_channel(5, 2) == 0
    assert pf.lime_clamp_channel(-1, 2) == 0
    assert pf.pluto_clamp_atten(5.0) == 0.0
    assert pf.pluto_clamp_atten(-20.0) == -20.0
    assert pf.pluto_clamp_atten(-100.0) == -80.0
    assert pf.pluto_clamp_bw(0.5e6) == 1.0e6
    assert pf.pluto_clamp_bw(3.0e6) == 3.0e6
    assert pf.pluto_clamp_bw(9.0e6) == 5.0e6
    assert pf.hackrf_filter_bw(2600000) == 2500000
    assert pf.hackrf_filter_bw(1750000) == 1750000
    assert pf.hackrf_filter_bw(10000000) == 9000000


# ---------------------------------------------------------------------------
# tools/uhd_player and the player pipe.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [16, 8, 1])
def test_uhd_player_sink_matches_jax_tool(tmp_path, bits):
    """--sink writes the JAX tool's fc32 bytes (scale 1/2048; x16 for SC08,
    x1000 for SC01), over more than one chunk; and torch.cuda is left
    alone."""
    pairs = uhd_player.CHUNK + 1000
    n_bytes = {16: 4 * pairs, 8: 2 * pairs, 1: pairs // 4}[bits]
    src = tmp_path / "sim.bin"
    src.write_bytes(np.random.default_rng(bits).integers(
        0, 256, n_bytes, dtype=np.uint8).tobytes())
    ours, theirs = tmp_path / "ours.fc32", tmp_path / "theirs.fc32"
    assert uhd_player.main(["-t", str(src), "-b", str(bits), "--no-repeat",
                            "--sink", str(ours)]) == 0
    subprocess.run([sys.executable, str(ROOT / "tools" / "uhd_player.py"),
                    "-t", str(src), "-b", str(bits), "--no-repeat",
                    "--sink", str(theirs)], check=True, capture_output=True)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.stat().st_size == 8 * {16: pairs, 8: pairs, 1: 4 * (
        pairs // 4)}[bits]
    assert not torch.cuda.is_initialized()


def test_uhd_player_without_uhd_or_sink(tmp_path, capsys):
    src = tmp_path / "sim.bin"
    src.write_bytes(bytes(16))
    assert uhd_player.main(["-t", str(src), "--no-repeat"]) == 1
    assert capsys.readouterr().err == (
        "ERROR: UHD python module not available; use --sink FILE to "
        "exercise the format path without hardware.\n")


@pytest.mark.usefixtures("one_torch_thread")
def test_cli_stdout_piped_into_the_player(tmp_path):
    """The port's CLI with -o - (--impl torch --device cpu, 0.3 s, 1 Msps)
    piped into gps-sdr-player -f - gives the player's output on the same
    capture written to a file. The player is built in a copy of tools/,
    so two test processes never run make in one directory."""
    src = tmp_path / "tools"
    shutil.copytree(ROOT / "tools", src, ignore=shutil.ignore_patterns(
        "gps-sdr-player", "nmea2um", "iqcompare", "*.so", "*.py",
        "*.script"))
    subprocess.run(["make", "-C", str(src), "gps-sdr-player"], check=True,
                   capture_output=True)
    player = str(src / "gps-sdr-player")
    cli = [sys.executable, "-m", "gps_sdr_sim_tpu_torch.cli", *STATIC,
           "--impl", "torch", "--device", "cpu"]
    cap, piped, direct = (tmp_path / n for n in ("cap.bin", "piped.bin",
                                                 "direct.bin"))
    subprocess.run(cli + ["-o", str(cap)], check=True, capture_output=True,
                   cwd=ROOT)
    gen = subprocess.Popen(cli + ["-o", "-"], stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, cwd=ROOT)
    play = subprocess.run([player, "-f", "-", "-b", "16", "-B", "file",
                           "-o", str(piped)], stdin=gen.stdout,
                          capture_output=True)
    gen.stdout.close()
    assert gen.wait(timeout=120) == 0 and play.returncode == 0, play.stderr
    subprocess.run([player, "-f", str(cap), "-b", "16", "-B", "file", "-o",
                    str(direct)], check=True, capture_output=True)
    assert cap.stat().st_size == 4 * 200000  # 2 epochs of 0.1 s, SC16
    assert piped.read_bytes() == direct.read_bytes()
    assert direct.read_bytes()[:cap.stat().st_size] == cap.read_bytes()
