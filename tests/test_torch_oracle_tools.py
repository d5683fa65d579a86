"""The port's oracle tools (gps_sdr_sim_tpu_torch.tools.fuzz_oracle and
.rtk_oracle) on the CPU, against the JAX package's tools/fuzz_oracle.py and
tools/rtk_oracle.py:

- gen_case draws the argv of all 56 cases that FUZZ_r05.json and
  FUZZ_PALLAS_r05.json recorded for seed 0, and the JAX tool's cases for
  other seeds;
- canon_stderr, load_iq and compare_case give the JAX tool's results on a
  fixture set (an oracle crash, rejection parity met and broken, SC16, SC08
  and SC01 streams inside and outside the budgets, size and stderr
  mismatches, CR progress, glog lines and a usage dump);
- one whole run_case: the port's CLI (plain version, CPU) against the JAX
  CLI standing in for the oracle;
- kinematic_errors equals the JAX tool's inline formula;
- the shared oracle build (float and fixed-point carrier NCO) on a stand-in
  reference, and each tool's exits without the reference or a card, in a
  process that blocks any import of JAX."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu_torch.testing import NAV, ROOT
from gps_sdr_sim_tpu_torch.tools import deepcheck, fuzz_oracle, rtk_oracle


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_fuzz():
    return _load("fuzz_oracle")


# ---------------------------------------------------------------------------
# The case matrix.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("artifact", ["FUZZ_r05.json", "FUZZ_PALLAS_r05.json"])
def test_gen_case_reproduces_the_committed_argv(artifact):
    """The artifacts recorded absolute paths under the checkout they ran
    in; those map onto this checkout."""
    run = json.loads((ROOT / artifact).read_text())
    assert (run["seed"], run["cases"], run["passed"]) == (0, 56, 56)
    recorded_root = os.path.dirname(os.path.dirname(
        run["detail"][0]["argv"][1]))
    cases = fuzz_oracle.gen_cases(run["cases"], run["seed"])
    for case, rec in zip(cases, run["detail"], strict=True):
        assert case["argv"] == [a.replace(recorded_root, str(ROOT))
                                for a in rec["argv"]]
        assert case["bits"] == rec["bits"]
        assert ("fixed" if case["fixed_carr"] else "float") == rec["carrier"]


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_gen_case_equals_jax_tool(jax_fuzz, seed):
    rng = np.random.default_rng(seed)
    want = [jax_fuzz.gen_case(rng, jax_fuzz.FORCED[k]
                              if k < len(jax_fuzz.FORCED) else None)
            for k in range(40)]
    assert fuzz_oracle.gen_cases(40, seed) == want
    assert fuzz_oracle.FORCED == jax_fuzz.FORCED


# ---------------------------------------------------------------------------
# canon_stderr, load_iq, compare_case.
# ---------------------------------------------------------------------------

_TABLE = ("Start time = 2014/12/19,23:59:44 (1823:518384)\n"
          "Duration = 0.5 [sec]\n"
          "05  291.8  21.3  23416478.3   6.4\n"
          "13   47.8  30.1  22571187.6   4.8\n")

STDERR = {
    "cr_progress": _TABLE + "Time into run = 0.1\rTime into run = 0.2\r"
                   "Time into run = 0.5\n\nDone!\nProcess time = 0.4 [sec]\n",
    "cr_rewrite_keeps_last": "junk\rSimulation done\n" + _TABLE,
    "glog": ("E0818 02:06:04.402693 32752 cpu_aot_loader.cc:210] cache "
             "features differ\n" + _TABLE
             + "W0101 00:00:00.000001 1 foo.cc:1] late\n"),
    "usage_dump": ("ERROR: Invalid sampling frequency.\nUsage: gps-sdr-sim "
                   "[options]\nOptions:\n  -e <gps_nav>  RINEX nav\n"),
    "options_only": "bad\nOptions:\n  -b <iq_bits>\n",
    "warnings": ("/x/y.py:3: UserWarning: something\n  warnings.warn(msg)\n"
                 "WARNING: skipped\n" + _TABLE + "Throughput = 9.1 Msps\n"),
    "blank_lines": "\n\n  \n" + _TABLE + "\n",
}


@pytest.mark.parametrize("name", sorted(STDERR))
def test_canon_stderr_equals_jax_tool(jax_fuzz, name):
    got = fuzz_oracle.canon_stderr(STDERR[name])
    assert got == jax_fuzz.canon_stderr(STDERR[name])
    assert not any("Time into run" in ln or "Usage:" in ln for ln in got)


@pytest.mark.parametrize("bits", [16, 8, 1])
def test_load_iq_equals_jax_tool(jax_fuzz, tmp_path, bits):
    path = tmp_path / "x.bin"
    np.random.default_rng(bits).integers(0, 256, 4000, np.uint8).tofile(path)
    got = fuzz_oracle.load_iq(str(path), bits)
    want = jax_fuzz.load_iq(str(path), bits)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _stream(bits, n, seed=0):
    """n values of a `bits` stream (SC01: n bits), as the file's bytes."""
    rng = np.random.default_rng(seed)
    if bits == 16:
        return rng.integers(-2000, 2000, n).astype(np.int16)
    if bits == 8:
        return rng.integers(-100, 100, n).astype(np.int8)
    return rng.integers(0, 256, n // 8).astype(np.uint8)


def _perturb(a, bits, where, delta):
    b = a.copy()
    if bits == 1:
        bits_ = np.unpackbits(b)
        bits_[where] ^= 1
        return np.packbits(bits_)
    b[where] = b[where] + delta
    return b


N = 400_000
# name: (bits, how ours differs from the oracle, expected pass)
STREAMS = {
    "sc16_equal": (16, lambda a: a, True),
    "sc16_inside": (16, lambda a: _perturb(
        _perturb(a, 16, np.arange(0, N, N // 30), 4), 16, [5, 7], 900),
        True),
    "sc16_too_many": (16, lambda a: _perturb(a, 16, np.arange(0, N, N // 60),
                                             1), False),
    "sc16_too_big": (16, lambda a: _perturb(a, 16, [3, 9, 11], 50), False),
    "sc08_inside": (8, lambda a: _perturb(a, 8, [1, 2, 3], 4), True),
    "sc08_outside": (8, lambda a: _perturb(a, 8, np.arange(0, N, N // 50),
                                           2), False),
    "sc01_inside": (1, lambda a: _perturb(a, 1, np.arange(0, N, N // 35), 0),
                    True),
    "sc01_outside": (1, lambda a: _perturb(a, 1, np.arange(0, N, N // 45), 0),
                     False),
    "size_mismatch": (16, lambda a: a[:-2], False),
}


def _proc(rc, err=_TABLE):
    return subprocess.CompletedProcess(["oracle"], rc, "", err)


def _case(bits, fixed=False):
    return {"argv": ["-e", str(NAV), "-b", str(bits)], "bits": bits,
            "fixed_carr": fixed}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_compare_case_streams_equal_jax_tool(jax_fuzz, tmp_path, name):
    bits, ours_of, ok = STREAMS[name]
    ref = _stream(bits, N)
    ref.tofile(tmp_path / "ref.bin")
    ours_of(ref).tofile(tmp_path / "ours.bin")
    args = (_case(bits, fixed=bits == 8), _proc(0), 0, tmp_path / "ours.bin",
            _TABLE, tmp_path / "ref.bin")
    got = fuzz_oracle.compare_case(*args)
    assert got == jax_fuzz.compare_case(*args)
    assert got["pass"] is ok
    assert got["stderr_match"] is True


# name: (oracle rc, oracle stderr, ours rc, ours stderr, expected result)
OUTCOMES = {
    "oracle_crash": (-6, "double free or corruption\n", 0, _TABLE, "skip"),
    "rejection_parity_met": (1, "ERROR: Invalid sampling frequency.\n"
                             "Usage: gps-sdr-sim\n", 1,
                             "ERROR: Invalid sampling frequency.\n"
                             "Usage: python -m cli\n", True),
    "rejection_rc_broken": (1, "ERROR: Invalid I/Q data format.\n", 0,
                            _TABLE, False),
    "rejection_message_broken": (1, "ERROR: Invalid date and time.\n", 1,
                                 "ERROR: Invalid sampling frequency.\n",
                                 False),
    "ours_rejects_alone": (0, _TABLE, 1, "ERROR: boom\n", False),
    "stderr_mismatch": (0, _TABLE, 0, _TABLE.replace("30.1", "30.2"), False),
    "stderr_extra_line": (0, _TABLE, 0, _TABLE + "a torch warning\n", False),
}


@pytest.mark.parametrize("name", sorted(OUTCOMES))
def test_compare_case_outcomes_equal_jax_tool(jax_fuzz, tmp_path, name):
    ref_rc, ref_err, ours_rc, ours_err, want = OUTCOMES[name]
    stream = _stream(16, 1000)
    for f in ("ours.bin", "ref.bin"):
        stream.tofile(tmp_path / f)
    args = (_case(16), _proc(ref_rc, ref_err), ours_rc, tmp_path / "ours.bin",
            ours_err, tmp_path / "ref.bin")
    got = fuzz_oracle.compare_case(*args)
    assert got == jax_fuzz.compare_case(*args)
    if want == "skip":
        assert got["skip"] == "oracle crashed (signal 6)"
    else:
        assert got["pass"] is want


# ---------------------------------------------------------------------------
# run_case end to end.
# ---------------------------------------------------------------------------


def test_run_case_port_cli_against_jax_cli(tmp_path, monkeypatch):
    """A 0.3 s 1 Msps static case with the fixed carrier: the port's CLI
    (plain version, CPU) against the JAX CLI (xla, CPU) as the oracle's
    stand-in, so the oracle command carries the carrier flag itself."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    case = {"argv": ["-e", str(NAV), "-s", "1000000", "-b", "16", "-d", "0.3",
                     "-l", "35.681298,139.766247,10.0", "-v"],
            "bits": 16, "fixed_carr": True}
    stand_in = [sys.executable, "-m", "gps_sdr_sim_tpu.cli", "--impl", "xla",
                "--carrier-phase", "fixed"]
    r = fuzz_oracle.run_case(case, fuzz_oracle.cli_command("torch", "cpu"),
                             stand_in, tmp_path, timeout=600)
    assert r["pass"] is True, r
    # -d 0.3 writes two 0.1 s epochs, as the reference does.
    assert (r["samples"], r["mismatch_fraction"], r["max_delta"]) == (
        400_000, 0.0, 0)
    assert r["size_match"] and r["stderr_match"]
    assert r["carrier"] == "fixed" and r["ours_s"] > 0 and r["oracle_s"] > 0
    assert list(tmp_path.iterdir()) == []  # both captures removed


# ---------------------------------------------------------------------------
# The RTK tool's trajectory errors.
# ---------------------------------------------------------------------------


def _jax_inline_errors(times, baselines, traj, g0_sow, kbase_xyz):
    """The loop of tools/rtk_oracle.py's kinematic closure, from
    `errs = []` to `errs = np.array(errs)`, run as written."""
    src = (ROOT / "tools" / "rtk_oracle.py").read_text().splitlines()
    lo = next(i for i, ln in enumerate(src) if ln.strip() == "errs = []")
    hi = next(i for i, ln in enumerate(src)
              if ln.strip() == "errs = np.array(errs)")
    ns = {"np": np, "ksol": type("K", (), {"times": times,
                                           "baselines": baselines}),
          "traj": traj, "g0_sow": g0_sow, "kbase_xyz": kbase_xyz}
    exec(textwrap.dedent("\n".join(src[lo:hi + 1])), ns)
    return ns["errs"]


def test_kinematic_errors_equal_jax_inline_formula():
    """A 50 m circle at 10 Hz; fixes a few mm off it at whole and fractional
    epochs, and one past the last row (the clamp)."""
    rng = np.random.default_rng(3)
    k = np.arange(300)
    base = np.array([-3961905.0, 3348993.0, 3698211.0])
    traj = base + 50.0 * np.stack([np.cos(k / 50), np.sin(k / 50),
                                   0 * k], axis=1)
    g0 = 518384.0
    times = g0 + np.array([0.0, 0.05, 1.0, 7.33, 12.96, 29.9, 29.95])
    truth = np.stack([np.interp((times - g0) * 10, k, traj[:, i])
                      for i in range(3)], axis=1)
    noise = rng.normal(0, 0.003, (times.size, 3))
    baselines = truth - base + noise
    got = rtk_oracle.kinematic_errors(times, baselines, traj, g0, base)
    want = _jax_inline_errors(times, baselines, traj, g0, base)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.linalg.norm(noise, axis=1),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The oracle build and the tools' exits.
# ---------------------------------------------------------------------------

_FAKE_C = r"""
#include <stdio.h>
#include "gpssim.h"
int main(void) {
#ifdef FLOAT_CARR_PHASE
    puts("float");
#else
    puts("fixed");
#endif
    return 0;
}
"""


def test_build_oracle_float_and_fixed(tmp_path):
    """One gcc call builds both oracles; the fixed one has FLOAT_CARR_PHASE
    commented out of gpssim.h."""
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "gpssim.c").write_text(_FAKE_C)
    (ref / "gpssim.h").write_text("#define FLOAT_CARR_PHASE // float NCO\n")
    for fixed, want in ((False, "float"), (True, "fixed")):
        exe = deepcheck.build_oracle(tmp_path / want, ref, fixed=fixed)
        out = subprocess.run([str(exe)], capture_output=True, text=True,
                             check=True).stdout
        assert out.strip() == want
    assert (ref / "gpssim.h").read_text().startswith("#define")


def test_build_oracle_needs_gcc(tmp_path, monkeypatch):
    ref = tmp_path / "ref"
    ref.mkdir()
    for f in deepcheck.REF_SOURCES:
        (ref / f).write_text("")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(deepcheck.ReferenceMissing,
                       match=f"gcc is not on PATH, so the C reference in "
                             f"{ref} cannot be built"):
        deepcheck.build_oracle(tmp_path / "b", ref)


# A stand-in for gpssim.c: it runs the port's CLI (plain version, CPU) with
# its own arguments, and with --carrier-phase fixed when gpssim.h does not
# define FLOAT_CARR_PHASE, as the fixed-NCO build of the reference.
_STAND_IN_C = r"""
#include <unistd.h>
#include "gpssim.h"
int main(int argc, char **argv) {
    char *args[argc + 10];
    int k = 0;
    args[k++] = PYTHON;
    args[k++] = "-m";
    args[k++] = "gps_sdr_sim_tpu_torch.cli";
    for (int i = 1; i < argc; i++) args[k++] = argv[i];
    args[k++] = "--impl";
    args[k++] = "closed";
    args[k++] = "--device";
    args[k++] = "cpu";
#ifndef FLOAT_CARR_PHASE
    args[k++] = "--carrier-phase";
    args[k++] = "fixed";
#endif
    args[k] = 0;
    execv(args[0], args);
    return 127;
}
"""


def test_fuzz_main_against_a_stand_in_reference(tmp_path, monkeypatch):
    """The tool's whole loop on the first FORCED case (NMEA, fixed carrier):
    both oracles built from a stand-in reference whose program runs the
    CLI's closed form, ours the CLI's plain version; the JSON report and
    the summary line carry the JAX tool's keys."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "gpssim.c").write_text(_STAND_IN_C)
    (ref / "gpssim.h").write_text(f"#define FLOAT_CARR_PHASE\n"
                                  f"#define PYTHON {json.dumps(sys.executable)}\n")
    out = tmp_path / "fuzz.json"
    assert fuzz_oracle.main(["--cpu", "--cases", "1", "--reference", str(ref),
                             "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert {k: v for k, v in report.items() if k != "detail"} == {
        "metric": "oracle_fuzz", "cases": 1, "seed": 0, "impl": "torch",
        "passed": 1, "failed": 0, "skipped": 0, "pass": True}
    (case,) = report["detail"]
    assert case["argv"] == fuzz_oracle.gen_cases(1)[0]["argv"]
    assert (case["carrier"], case["mismatch_fraction"], case["max_delta"],
            case["stderr_match"]) == ("fixed", 0.0, 0, True)


_NO_JAX = r"""
import sys
BLOCKED = ("jax", "gps_sdr_sim_tpu", "tools", "__graft_entry__", "bench",
           "bench_scaling", "deepcheck", "dayrun")
for name in BLOCKED:
    sys.modules[name] = None
import importlib
tool = importlib.import_module("gps_sdr_sim_tpu_torch.tools." + sys.argv[1])
rc = tool.main(sys.argv[2:])
assert not any(m.split(".")[0] in BLOCKED
               for m in sys.modules if sys.modules[m] is not None), \
    "jax, gps_sdr_sim_tpu or a root tool was imported"
sys.exit(rc)
"""


def _tool(name, *argv):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    return subprocess.run([sys.executable, "-c", _NO_JAX, name, *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("name,rc", [("fuzz_oracle", 2), ("rtk_oracle", 1)])
def test_tools_without_the_reference(tmp_path, name, rc):
    empty = tmp_path / "empty"
    empty.mkdir()
    proc = _tool(name, "--cpu", "--reference", str(empty))
    assert proc.returncode == rc, proc.stderr
    assert (f"ERROR: the C reference is not in {empty} (missing gpssim.c, "
            f"gpssim.h)") in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("name", ["fuzz_oracle", "rtk_oracle"])
def test_tools_need_a_card_or_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _tool(name, "--reference", str(tmp_path))
    assert proc.returncode == 1, proc.stderr
    assert proc.stderr.startswith("ERROR: no CUDA device (use --cpu")
    assert proc.stdout == ""


@pytest.mark.parametrize("impl", ["cuda", "cuda-sharded"])
def test_fuzz_refuses_a_card_impl_on_the_cpu(capsys, impl):
    assert fuzz_oracle.main(["--cpu", "--impl", impl]) == 1
    assert capsys.readouterr().err == (
        f"ERROR: --impl {impl} runs the CUDA kernel and needs a card; with "
        f"--cpu use torch, torch-sharded, closed or closed-sharded\n")


@pytest.mark.slow
def test_rtk_oracle_closes_on_the_plain_version(tmp_path):
    """The whole tool on the CPU (four 26 s captures tracked on one thread),
    with the CLI's plain version behind a wrapper as its oracle: both
    closures fix within the tool's thresholds."""
    wrapper = tmp_path / "gps-sdr-sim"
    wrapper.write_text(
        f"#!{sys.executable}\nimport runpy, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.argv += ['--impl', 'torch', '--device', 'cpu']\n"
        f"runpy.run_module('gps_sdr_sim_tpu_torch.cli', run_name='__main__')\n")
    wrapper.chmod(0o755)
    out = tmp_path / "rtk.json"
    assert rtk_oracle.main(["--cpu", "--oracle", str(wrapper),
                            "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    st, kn = report["closures"]["static"], report["closures"]["kinematic"]
    assert st["fixed"] and st["fixed_error_mm"] < 10
    assert kn["fixed"] and kn["track_err_max_mm"] < 50
    assert report["oracle"] == str(wrapper)
