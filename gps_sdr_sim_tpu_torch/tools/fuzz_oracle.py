"""Randomized-scenario oracle fuzz: drive the port's CLI and the C reference
over a seeded random matrix of configurations and diff BOTH output
channels: the sample stream (per-format error budget) and the stderr
channel tables (compared line for line after stripping progress lines).

Counterpart of the repository's root tools/fuzz_oracle.py, on the port's
CLI: the same matrix (gen_case draws the same argv from the same seed), the
same pass rules and the same JSON keys. Dimensions fuzzed per case:
position (random -l LLH or -c ECEF, incl. negative getopt operands and
receivers up to 9,000 km high), trajectory mode (static / -u user motion /
-g NMEA / rocket and satellite), sample rate (incl. non-multiple-of-10
values, exercising the flooring of gpssim.c:1876-1879), output format
(-b 1/8/16), duration (FORCED's long band crosses the 30 s nav and
re-allocation boundaries), start time (-t / -T within the ephemeris span),
iono disable (-i), verbose (-v), and carrier NCO mode (--carrier-phase
fixed against a reference build with FLOAT_CARR_PHASE undefined).

    python -m gps_sdr_sim_tpu_torch.tools.fuzz_oracle [--cases 16] \\
        [--seed 0] [--json out.json] [--impl cuda] [--cpu] [--reference DIR]

--impl takes the CLI's impls (runner.IMPLS): cuda, the default, stands for
the JAX tool's pallas and closed for its xla. The CLI runs on the card;
--cpu passes it --device cpu (default impl torch, the kernel's plain
version) and refuses the impls that need a card. Without a card and
without --cpu the tool exits 1. The two oracles (float and fixed-point
carrier NCO) are built from gpssim.c and gpssim.h in --reference (default:
$GPS_SDR_SIM_REFERENCE, else the directory `reference` inside the
repository) by deepcheck.build_oracle; without them, or without gcc, the
tool exits 2 and names what is missing. run_case runs one case against any
command that takes gps-sdr-sim's flags, so the CLI's plain version can stand
in for the oracle where the C reference is absent.

Exit 0 = every case passed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.runner import IMPLS
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools.deepcheck import (
    REF,
    ReferenceMissing,
    build_oracle,
)

NAV = str(ROOT / "data" / "brdc3540.14n")


def llh2xyz(llh_deg):
    """WGS84 geodetic (degrees) -> ECEF, matching gpssim.c:279-311. The JAX
    tool's own formula, kept so that every -c operand is its to the last
    digit."""
    a, e2 = 6378137.0, 0.00669437999014
    lat, lon, hgt = np.radians(llh_deg[0]), np.radians(llh_deg[1]), llh_deg[2]
    n = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    return ((n + hgt) * np.cos(lat) * np.cos(lon),
            (n + hgt) * np.cos(lat) * np.sin(lon),
            (n * (1.0 - e2) + hgt) * np.sin(lat))


# Guaranteed fixed-NCO crossings: the first len(FORCED) cases of every run
# pin these axes; everything else in the case still comes from the seeded
# rng. The fixed-carrier variant interacts with start-time handling
# (gpssim.c:1978-2015,2175-2177) and is documented "For RKT simulation",
# hence the spacecraft crossings.
FORCED = (
    {"mode": "gga", "fixed": True},
    {"mode": "gga", "fixed": True, "tflag": "-T"},
    {"mode": "gga", "fixed": True, "tflag": "-t"},
    {"mode": "rkt", "fixed": True, "traj": "satellite.csv"},
    {"mode": "rkt", "fixed": True, "traj": "rocket.csv", "tflag": "-T"},
    {"mode": "rkt", "fixed": True, "traj": "satellite.csv", "tflag": "-T"},
    {"mode": "um", "fixed": True, "tflag": "-T"},
    {"mode": "static", "fixed": True, "tflag": "-T"},
    # Long band: durations 31-95 s cross the reference's 30 s cadence under
    # randomized rates/formats/trajectories: nav-message carry of
    # dwrd[50..59] (gpssim.c:1503-1519), ephemeris handling at boundaries,
    # and channel re-allocation with satellite rise/set
    # (gpssim.c:2293-2345). Rates are drawn low (and odd) to keep the
    # C oracle's runtime sane; every trajectory file covers >=156 s.
    {"mode": "um", "long": True},
    {"mode": "um", "long": True, "fixed": True},
    {"mode": "gga", "long": True},
    {"mode": "static", "long": True, "fixed": True, "tflag": "-T"},
    {"mode": "static", "long": True},
    {"mode": "rkt", "long": True, "traj": "satellite.csv"},
    {"mode": "static", "long": True, "tflag": "-t"},
    {"mode": "rkt", "long": True, "traj": "rocket.csv", "fixed": True},
)


def gen_case(rng: np.random.Generator, force: dict | None = None) -> dict:
    force = force or {}
    mode = force.get("mode") or rng.choice(
        ["static", "static", "static", "um", "gga", "rkt"])
    bits = int(rng.choice([1, 8, 16]))
    if force.get("long"):
        # 31-95 s: at least one 30 s nav/re-allocation boundary, often
        # three; random non-multiple-of-10 rates stay near 1 Msps so the
        # single-core C oracle finishes each case in seconds.
        fs = float(rng.integers(1_000_000, 1_350_000))
        dur = round(float(rng.uniform(31.0, 95.0)), 1)
    else:
        fs_pool = [1.0e6, 1.5e6, 2.048e6, 2.6e6, 3.2e6,
                   float(rng.integers(1_000_000, 3_500_000))]
        fs = float(rng.choice(fs_pool))
        dur = round(float(rng.uniform(0.4, 2.0)), 1)
    # ~1/3 of unforced cases run the 32-bit fixed-point carrier NCO on top
    # of the FORCED crossing templates above.
    fixed_carr = bool(force.get("fixed", rng.random() < 0.35))
    argv = ["-e", NAV, "-s", f"{fs:.0f}", "-b", str(bits), "-d", str(dur)]
    if mode == "static":
        lat = float(rng.uniform(-65.0, 70.0))
        lon = float(rng.uniform(-180.0, 180.0))
        if rng.random() < 0.25:
            # High-altitude receiver (up to ~9,000 km): satellites pass
            # inside 20,200 km, so channel gains reach the large-gain
            # regime (spacecraft regime, gpssim.c:2178-2186).
            hgt = float(rng.integers(100_000, 9_000_000))
        else:
            hgt = float(rng.integers(0, 8000))
        if rng.random() < 0.3:  # ECEF form, negative operands likely
            x, y, z = llh2xyz((lat, lon, hgt))
            argv += ["-c", f"{x:.1f},{y:.1f},{z:.1f}"]
        else:
            argv += ["-l", f"{lat:.6f},{lon:.6f},{hgt:.1f}"]
    elif mode == "um":
        argv += ["-u", str(ROOT / "data" / "circle.csv")]
    elif mode == "rkt":
        # Spacecraft dynamics (reference README.md: disable the iono model
        # above the atmosphere; FLOAT_CARR_PHASE notes "For RKT simulation")
        traj = force.get("traj") or rng.choice(["rocket.csv",
                                                "satellite.csv"])
        argv += ["-u", str(ROOT / "data" / traj), "-i"]
    else:
        argv += ["-g", str(ROOT / "data" / "triumphv3.txt")]
    if "-i" not in argv and rng.random() < 0.25:
        argv += ["-i"]
    if rng.random() < 0.3:
        argv += ["-v"]
    if force.get("tflag") or rng.random() < 0.3:
        hh = int(rng.integers(1, 22))
        # -T overwrites all TOC/TOE to the start time rounded to 2 h
        # (gpssim.c:1978-2015); with an explicit date it is deterministic,
        # so both binaries see identical shifted ephemerides.
        flag = force.get("tflag") or (
            "-T" if rng.random() < 0.4 else "-t")
        argv += [flag, f"2014/12/20,{hh:02d}:{int(rng.integers(60)):02d}:00"]
    return {"argv": argv, "bits": bits, "fixed_carr": fixed_carr}


def gen_cases(n: int, seed: int = 0) -> list:
    """The first `n` cases of `seed`'s run, FORCED's templates first."""
    rng = np.random.default_rng(seed)
    return [gen_case(rng, FORCED[k] if k < len(FORCED) else None)
            for k in range(n)]


_PROGRESS_MARKERS = ("Time into run", "Process time", "Throughput =",
                     "WARNING:", "warnings.warn")
# absl/glog diagnostics a JAX oracle stand-in may emit to stderr:
# "E0818 02:06:04.402693 32752 cpu_aot_loader.cc:210] ..."
_GLOG_RE = re.compile(r"[EWIF]\d{4} \d\d:\d\d:\d\d\.\d+\s+\d+ \S+:\d+\]")


def canon_stderr(text: str) -> list:
    """stderr -> comparable lines: drop \\r-progress and per-impl extras;
    stop at a usage dump (diagnostics only: argv[0] spellings differ
    inside usage text)."""
    out = []
    for raw in text.splitlines():
        ln = raw.split("\r")[-1]  # keep only what survives the CR rewrites
        if ln.startswith("Usage:") or ln.startswith("Options:"):
            break
        if not ln.strip():
            continue
        if any(m in ln for m in _PROGRESS_MARKERS):
            continue
        if _GLOG_RE.match(ln):
            continue
        out.append(ln)
    return out


def load_iq(path: str, bits: int) -> np.ndarray:
    if bits == 16:
        return np.fromfile(path, np.int16).astype(np.int32)
    if bits == 8:
        return np.fromfile(path, np.int8).astype(np.int32)
    b = np.unpackbits(np.fromfile(path, np.uint8))
    return b.astype(np.int32) * 2 - 1


def compare_case(case, ref, ours_rc, ours_bin, ours_err, ref_bin) -> dict:
    """Classify one case. Both CLIs have already run; acceptance parity is
    part of the contract: our CLI accepting a config the reference rejects
    (or vice versa) is a failure, not a skip; the only skip is a reference
    CRASH (signal exit, e.g. its SC01 heap overflow)."""
    result = {"argv": case["argv"], "bits": case["bits"],
              "carrier": "fixed" if case["fixed_carr"] else "float"}
    if ref.returncode < 0:
        result["skip"] = f"oracle crashed (signal {-ref.returncode})"
        result["ours_rc"] = ours_rc
        return result
    if ref.returncode != 0 or ours_rc != 0:
        # Rejection parity: same exit code and same diagnostic lines.
        same_rc = ours_rc == ref.returncode
        same_msg = canon_stderr(ours_err) == canon_stderr(ref.stderr)
        result.update({
            "ref_rc": ref.returncode, "ours_rc": ours_rc,
            "stderr_match": same_msg, "pass": same_rc and same_msg,
        })
        if not result["pass"]:
            result["ours_stderr"] = ours_err[-800:]
            result["ref_stderr"] = ref.stderr[-800:]
        return result

    a = load_iq(str(ours_bin), case["bits"])
    b = load_iq(str(ref_bin), case["bits"])
    n = min(a.size, b.size)
    d = np.abs(a[:n] - b[:n])
    frac = float(np.count_nonzero(d) / max(n, 1))
    # 1-bit streams are sign bits: a razor's-edge accumulator flips the
    # whole sample, so only the fraction budget applies there.
    max_delta = int(d.max(initial=0))
    big = int(np.count_nonzero(d > 4)) if case["bits"] != 1 else 0
    big_budget = 2 + n // 25_000_000
    sample_ok = (a.size == b.size and frac <= 1e-4
                 and (case["bits"] == 1 or big <= big_budget))

    tbl_ref = canon_stderr(ref.stderr)
    tbl_ours = canon_stderr(ours_err)
    stderr_ok = tbl_ours == tbl_ref

    result.update({
        "samples": n, "mismatch_fraction": round(frac, 9),
        "max_delta": max_delta, "big": big,
        "size_match": a.size == b.size, "stderr_match": stderr_ok,
        "pass": sample_ok and stderr_ok,
    })
    if not stderr_ok:
        result["stderr_diff"] = [
            [x, y] for x, y in zip(tbl_ours, tbl_ref) if x != y][:5]
    return result


def cli_command(impl: str, device: str) -> list:
    """The port's CLI under `impl` on `device`, without the case's argv."""
    return [sys.executable, "-m", "gps_sdr_sim_tpu_torch.cli",
            "--impl", impl, "--device", device]


def run_case(case, ours_cmd, oracle_cmd, tmp, timeout: float) -> dict:
    """Run one case and classify it with compare_case.

    ours_cmd: the port's CLI (cli_command), given the case's argv, -o and,
    for the fixed carrier, --carrier-phase fixed. oracle_cmd: the C build
    that the case's carrier selects, or any stand-in that takes the same
    argv and -o. Both write into `tmp`; the files are removed after the
    comparison. Our CLI gets `timeout` seconds and one retry: the first run
    on a card pays the kernel's build. Adds both walls, ours_s and
    oracle_s."""
    tmp = pathlib.Path(tmp)
    ours_bin, ref_bin = tmp / "ours.bin", tmp / "ref.bin"
    argv_ours = case["argv"] + ["-o", str(ours_bin)]
    if case["fixed_carr"]:
        argv_ours += ["--carrier-phase", "fixed"]
    for attempt in (0, 1):
        # t0 resets per attempt so ours_s covers the successful run only.
        t0 = time.time()
        try:
            ours = subprocess.run(
                list(ours_cmd) + argv_ours, capture_output=True, text=True,
                timeout=timeout, cwd=str(ROOT))
            break
        except subprocess.TimeoutExpired:
            if attempt:
                raise
            print(f"CLI exceeded {timeout:.0f} s, one retry",
                  file=sys.stderr)
    t_ours = time.time() - t0
    t0 = time.time()
    ref = subprocess.run(
        list(oracle_cmd) + case["argv"] + ["-o", str(ref_bin)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    t_ref = time.time() - t0
    try:
        r = compare_case(case, ref, ours.returncode, ours_bin, ours.stderr,
                         ref_bin)
    finally:
        ours_bin.unlink(missing_ok=True)
        ref_bin.unlink(missing_ok=True)
    r["ours_s"] = round(t_ours, 2)
    r["oracle_s"] = round(t_ref, 2)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.fuzz_oracle",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default=None, choices=IMPLS,
                    help="the CLI's impl (default: cuda, or torch with "
                         "--cpu); cuda stands for the JAX tool's pallas, "
                         "closed for its xla")
    ap.add_argument("--cpu", action="store_true",
                    help="run the CLI with --device cpu; without it the "
                         "CLI needs a card")
    ap.add_argument("--reference", default=str(REF),
                    help="directory of the C reference's gpssim.c/.h")
    ap.add_argument("--json", default="")
    ap.add_argument("--case-timeout", type=float, default=900.0,
                    help="per-case wall limit for OUR CLI, with one retry")
    ns = ap.parse_args(argv)
    impl = ns.impl or ("torch" if ns.cpu else "cuda")
    if ns.cpu and impl.startswith("cuda"):
        print(f"ERROR: --impl {impl} runs the CUDA kernel and needs a card; "
              f"with --cpu use torch, torch-sharded, closed or "
              f"closed-sharded", file=sys.stderr)
        return 1
    if not ns.cpu and not torch.cuda.is_available():
        print("ERROR: no CUDA device (use --cpu to run the CLI on the host "
              "CPU)", file=sys.stderr)
        return 1

    results = []
    n_pass = n_fail = n_skip = 0
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        try:
            oracles = {False: build_oracle(tmp / "float", ns.reference),
                       True: build_oracle(tmp / "fixed", ns.reference,
                                          fixed=True)}
        except ReferenceMissing as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
        ours_cmd = cli_command(impl, "cpu" if ns.cpu else "cuda")
        for k, case in enumerate(gen_cases(ns.cases, ns.seed)):
            r = run_case(case, ours_cmd, [str(oracles[case["fixed_carr"]])],
                         tmp, ns.case_timeout)
            results.append(r)
            if "skip" in r:
                n_skip += 1
            elif r["pass"]:
                n_pass += 1
            else:
                n_fail += 1
            print(f"case {k}: {json.dumps(r)}", file=sys.stderr)
            if ns.json:  # incremental: a crash/kill keeps finished cases
                pathlib.Path(ns.json).write_text(json.dumps({
                    "metric": "oracle_fuzz", "cases": ns.cases,
                    "seed": ns.seed, "impl": impl,
                    "completed": k + 1, "passed": n_pass,
                    "failed": n_fail, "skipped": n_skip,
                    "pass": n_fail == 0 and k + 1 == ns.cases,
                    "detail": results}, indent=1))

    summary = {
        "metric": "oracle_fuzz", "cases": ns.cases, "seed": ns.seed,
        "impl": impl, "passed": n_pass, "failed": n_fail,
        "skipped": n_skip, "pass": n_fail == 0, "detail": results,
    }
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "detail"}))
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
