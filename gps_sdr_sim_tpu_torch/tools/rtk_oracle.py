"""RTK closure against an oracle's own signals: the reference's `rtk/`
validation chain (simulate -> receive -> RTKCONV -> RTKLIB fix, SURVEY.md
§2.3), run end to end in software on oracle-generated IQ.

Counterpart of the repository's root tools/rtk_oracle.py, on the port's
receiver. Two closures, each proving that the oracle's carrier is
phase-coherent across scenario runs AND that the port's receiver/RTK chain
resolves it:

 - static: two captures ~32 m apart -> track -> RINEX pair ->
   double-difference fix; expect a millimetre-level baseline (reference
   evidence: rtk/rtklib/rtkpost.png).
 - kinematic: static base at the circle.csv centroid + a moving rover
   (`-u data/circle.csv`, the shape of the reference's rtk/rover.csv
   dataset) -> per-epoch fixed baselines landing on the simulated
   trajectory (reference evidence: rtk/rtklib/gndtrk.png ground track).

    python -m gps_sdr_sim_tpu_torch.tools.rtk_oracle [--json out.json] \\
        [--duration 26] [--oracle PATH] [--reference DIR] [--cpu]

A file at --oracle is used as is: any executable that takes gps-sdr-sim's
flags, such as the port's own CLI behind a wrapper. Otherwise the C
reference is built (deepcheck.build_oracle) from gpssim.c and gpssim.h in
--reference (default: $GPS_SDR_SIM_REFERENCE, else the directory
`reference` inside the repository); without them the tool exits 1 and
names the directory. Acquisition and tracking run on the card; --cpu runs
them on the host CPU. Without a card and without --cpu the tool exits 1.
The captures (about 213 MB each at 26 s) live in a temporary directory, and
each is removed once tracked. Exit 0 = both closures fixed within
thresholds.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.models.ephemeris import IonoUtc, read_rinex_nav_all
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.models.trajectory import read_user_motion
from gps_sdr_sim_tpu_torch.receiver import acquire, load_iq, track
from gps_sdr_sim_tpu_torch.receiver.rinex import write_nav, write_obs
from gps_sdr_sim_tpu_torch.receiver.rinexobs import read_rinex_obs
from gps_sdr_sim_tpu_torch.receiver.rtk import solve_baseline
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools.deepcheck import (
    REF,
    ReferenceMissing,
    build_oracle,
)
from gps_sdr_sim_tpu_torch.utils.coord import llh2xyz, xyz2llh

NAV = str(ROOT / "data" / "brdc3540.14n")
CIRCLE = str(ROOT / "data" / "circle.csv")
FS = 2_048_000

BASE_LLH = (35.681298, 139.766247, 10.0)
ROVER_LLH = (35.681298 + 0.00020, 139.766247 + 0.00025, 12.0)


def ensure_oracle(path, tmp: pathlib.Path, ref=None) -> pathlib.Path:
    """The file at `path` as is, if there is one; else the C reference in
    `ref` built in `tmp` (raises ReferenceMissing without its sources)."""
    if path and pathlib.Path(path).is_file():
        return pathlib.Path(path)
    return build_oracle(tmp, ref)


def oracle_capture(oracle, out, duration, llh=None, motion=None) -> float:
    """One SC16 capture at FS by `oracle`; returns its wall seconds."""
    args = [str(oracle), "-e", NAV, "-s", str(FS), "-b", "16",
            "-d", str(duration), "-o", str(out)]
    if llh is not None:
        args += ["-l", f"{llh[0]},{llh[1]},{llh[2]}"]
    if motion is not None:
        args += ["-u", motion]
    t0 = time.time()
    subprocess.run(args, check=True, capture_output=True)
    return time.time() - t0


def track_capture(path, device):
    """Acquire (50 Hz Doppler steps) and track the SC16 capture at `path`
    on `device`, then remove the file."""
    x = load_iq(str(path), 16)
    pathlib.Path(path).unlink()
    return track(x, FS, acquire(x, FS, dopp_step=50.0, device=device),
                 device=device)


def solve_pair(tr_rov, tr_base, base_xyz, kinematic: bool, tmp):
    """The rover and base TrackResults as RINEX obs (1 s epochs), the base's
    decoded ephemerides as RINEX nav, solved as a double-difference
    baseline with the base at `base_xyz`."""
    fo_b, fo_r, fn = io.StringIO(), io.StringIO(), io.StringIO()
    write_obs(fo_b, tr_base, interval=1.0, approx_xyz=base_xyz)
    write_obs(fo_r, tr_rov, interval=1.0)
    write_nav(fn, tr_base)
    navp = pathlib.Path(tmp) / "rx.nav"
    navp.write_text(fn.getvalue())
    eph, _ = read_rinex_nav_all(str(navp), IonoUtc())
    eph_by_prn = {k + 1: eph[0][k] for k in range(32) if eph[0][k].vflg}
    return solve_baseline(read_rinex_obs(io.StringIO(fo_r.getvalue())),
                          read_rinex_obs(io.StringIO(fo_b.getvalue())),
                          eph_by_prn, base_xyz=base_xyz, kinematic=kinematic)


def kinematic_errors(times, baselines, traj, g0_sow, base_xyz) -> np.ndarray:
    """Distance (m) of each epoch's fixed position, base_xyz + baseline,
    from the trajectory `traj` (10 Hz ECEF rows from time of week g0_sow),
    linearly interpolated at the epoch's time of week."""
    errs = []
    for t, bl in zip(times, baselines):
        tt = (t - g0_sow) * 10.0
        i0 = int(tt)
        frac = tt - i0
        truth = traj[i0] * (1 - frac) + traj[min(i0 + 1,
                                                 len(traj) - 1)] * frac
        errs.append(np.linalg.norm(base_xyz + bl - truth))
    return np.array(errs)


def _xyz(llh_deg) -> np.ndarray:
    d2r = np.pi / 180.0
    return llh2xyz(np.array([llh_deg[0] * d2r, llh_deg[1] * d2r,
                             llh_deg[2]]))


def static_closure(oracle, duration, device, tmp) -> dict:
    base_xyz, rover_xyz = _xyz(BASE_LLH), _xyz(ROVER_LLH)
    print("[static] oracle captures...", flush=True)
    oracle_capture(oracle, tmp / "base.bin", duration, llh=BASE_LLH)
    oracle_capture(oracle, tmp / "rover.bin", duration, llh=ROVER_LLH)
    print("[static] tracking base...", flush=True)
    tr_base = track_capture(tmp / "base.bin", device)
    print("[static] tracking rover...", flush=True)
    tr_rov = track_capture(tmp / "rover.bin", device)
    sol = solve_pair(tr_rov, tr_base, base_xyz, False, tmp)
    err = np.linalg.norm(sol.baseline - (rover_xyz - base_xyz))
    st = {"n_sats": sol.n_sats, "n_epochs": sol.n_epochs,
          "fixed": bool(sol.fixed), "ratio": round(sol.ratio, 1),
          "dd_phase_rms_mm": round(sol.phase_rms * 1e3, 3),
          "n_slips": sol.n_slips,
          "true_baseline_m": round(float(np.linalg.norm(
              rover_xyz - base_xyz)), 3),
          "fixed_error_mm": round(float(err) * 1e3, 3),
          "pass": bool(sol.fixed and err < 0.01)}
    print(f"[static] fixed={st['fixed']} ratio={st['ratio']} "
          f"err={st['fixed_error_mm']} mm  PASS={st['pass']}", flush=True)
    return st


def kinematic_closure(oracle, duration, device, tmp) -> dict:
    d2r = np.pi / 180.0
    traj = read_user_motion(CIRCLE)
    cl = xyz2llh(traj.mean(axis=0))
    center_llh = (cl[0] / d2r, cl[1] / d2r, cl[2])
    print("[kinematic] oracle captures...", flush=True)
    oracle_capture(oracle, tmp / "kbase.bin", duration, llh=center_llh)
    oracle_capture(oracle, tmp / "krover.bin", duration, motion=CIRCLE)
    # The oracle's start time g0 follows the same ephemeris-selection rule
    # as the port's (CLI parity): recover it from the scenario builder.
    scn = build_scenario(ScenarioConfig(nav_file=NAV, motion_file=CIRCLE,
                                        duration=duration, samp_freq=FS,
                                        data_format=16))
    # llh2xyz(xyz2llh(center)) != center by the iterative-inverse
    # residual; anchor at the position the oracle actually simulated.
    kbase_xyz = llh2xyz(np.array([cl[0], cl[1], cl[2]]))
    print("[kinematic] tracking base...", flush=True)
    tr_kbase = track_capture(tmp / "kbase.bin", device)
    print("[kinematic] tracking rover...", flush=True)
    tr_krov = track_capture(tmp / "krover.bin", device)
    ksol = solve_pair(tr_krov, tr_kbase, kbase_xyz, True, tmp)
    errs = kinematic_errors(ksol.times, ksol.baselines, traj, scn.g0.sec,
                            kbase_xyz)
    kn = {"n_sats": ksol.n_sats, "n_epochs": ksol.n_epochs,
          "fixed": bool(ksol.fixed), "ratio": round(ksol.ratio, 1),
          "dd_phase_rms_mm": round(ksol.phase_rms * 1e3, 3),
          "n_slips": ksol.n_slips,
          "track_err_max_mm": round(float(errs.max()) * 1e3, 1),
          "track_err_mean_mm": round(float(errs.mean()) * 1e3, 1),
          "pass": bool(ksol.fixed and errs.max() < 0.05)}
    print(f"[kinematic] fixed={kn['fixed']} ratio={kn['ratio']} "
          f"worst={kn['track_err_max_mm']} mm  PASS={kn['pass']}",
          flush=True)
    return kn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.rtk_oracle",
        description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--duration", type=float, default=26.0,
                    help="capture length (>=26 s: subframes 1-4 decode)")
    ap.add_argument("--oracle", default="",
                    help="a gps-sdr-sim executable, used as is; without it "
                         "the C reference is built from --reference")
    ap.add_argument("--reference", default=str(REF),
                    help="directory of the C reference's gpssim.c/.h")
    ap.add_argument("--cpu", action="store_true",
                    help="acquire and track on the host CPU; without it "
                         "the receiver needs a card")
    ns = ap.parse_args(argv)
    if not ns.cpu and not torch.cuda.is_available():
        print("ERROR: no CUDA device (use --cpu to run the receiver on the "
              "host CPU)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if ns.cpu else "cuda")

    with tempfile.TemporaryDirectory(prefix="rtkoracle-") as td:
        tmp = pathlib.Path(td)
        try:
            oracle = ensure_oracle(ns.oracle, tmp / "ref", ns.reference)
        except ReferenceMissing as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        report = {"oracle": str(oracle), "duration_s": ns.duration,
                  "samp_freq": FS, "closures": {
                      "static": static_closure(oracle, ns.duration, device,
                                               tmp),
                      "kinematic": kinematic_closure(oracle, ns.duration,
                                                     device, tmp)}}
    report["pass"] = all(c["pass"] for c in report["closures"].values())
    out = json.dumps(report, indent=1)
    print(out)
    if ns.json:
        pathlib.Path(ns.json).write_text(out + "\n")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
