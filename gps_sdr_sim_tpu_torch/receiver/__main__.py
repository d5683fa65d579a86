"""Receiver CLI: acquire, track, and decode a gpssim.bin file.

The software analogue of the reference's receiver-screenshot validation
(u-center.png / rtk/ — SURVEY.md §4): point it at a synthesized capture and
it prints the acquired channels and the decoded nav-message TOW/week.

Acquisition and tracking run on the CUDA card; --cpu runs them on the host
CPU instead. Without a card and without --cpu it exits 1.

Usage:
  python -m gps_sdr_sim_tpu_torch.receiver <iq_file> [-s freq] [-b 1|8|16]
                                           [-d seconds] [--track seconds]
                                           [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gps-sdr-rx")
    ap.add_argument("file")
    ap.add_argument("-s", type=float, default=2.6e6, dest="samp_freq")
    ap.add_argument("-b", type=int, default=16, dest="bits",
                    choices=(1, 8, 16))
    ap.add_argument("-d", type=float, default=0.1, dest="acq_seconds",
                    help="seconds of signal for acquisition")
    ap.add_argument("--track", type=float, default=0.0, metavar="SECONDS",
                    help="track + decode this many seconds")
    ap.add_argument("--pvt", action="store_true",
                    help="solve a position fix from the decoded ephemerides "
                         "(needs >=19 s of signal for subframes 1-3)")
    ap.add_argument("--dopp-step", type=float, default=50.0)
    ap.add_argument("--dopp-max", type=float, default=5000.0,
                    help="half-width of the acquisition Doppler search "
                         "(Hz); spacecraft captures (rocket/satellite "
                         "trajectories) need ~45000")
    ap.add_argument("--weighted", action="store_true",
                    help="C/N0-weighted least squares for the PVT fix")
    ap.add_argument("--pvt-track", type=float, default=0.0, metavar="SEC",
                    help="with --pvt: also solve a per-epoch single-point "
                         "position/velocity track at this interval (the "
                         "rtkpost 'single'-mode .pos analogue)")
    ap.add_argument("--rinex-obs", default="", metavar="FILE",
                    help="write RINEX 2.11 observations (C1 L1 D1 S1, the "
                         "software RTKCONV of the reference's rtk/ flow)")
    ap.add_argument("--rinex-nav", default="", metavar="FILE",
                    help="write decoded ephemerides as RINEX 2.11 GPS nav")
    ap.add_argument("--obs-interval", type=float, default=1.0,
                    help="RINEX observation epoch interval (s)")
    ap.add_argument("--gps-era", type=int, default=1,
                    help="GPS 1024-week rollover count for RINEX dating "
                         "(the signal carries only week mod 1024): 1 = "
                         "1999-08..2019-04 (the bundled 2014 data), 2 = "
                         "2019-04..2038-11")
    ap.add_argument("--cpu", action="store_true",
                    help="acquire and track on the host CPU (default: the "
                         "CUDA card)")
    ns = ap.parse_args(argv)
    if (ns.rinex_obs or ns.rinex_nav) and ns.track <= 0:
        ap.error("--rinex-obs/--rinex-nav require --track SECONDS")
    if ns.pvt and ns.track <= 0:
        ap.error("--pvt requires --track SECONDS (>=19 s of signal to "
                 "decode subframes 1-3)")
    if ns.pvt_track > 0 and not ns.pvt:
        ap.error("--pvt-track requires --pvt")
    if not ns.cpu and not torch.cuda.is_available():
        print("ERROR: no CUDA device (use --cpu to run on the host CPU)",
              file=sys.stderr)
        return 1
    device = torch.device("cpu" if ns.cpu else "cuda")

    from gps_sdr_sim_tpu_torch.receiver import acquire, load_iq, track

    n = int(max(ns.acq_seconds, ns.track) * ns.samp_freq)
    x = load_iq(ns.file, ns.bits, count=n)
    print(f"loaded {len(x):,} samples ({len(x) / ns.samp_freq:.2f} s)",
          file=sys.stderr)

    # The JAX CLI takes acquire_mxu only on a backend without complex64;
    # CUDA and the CPU both have it, so the FFT search always.
    acq = acquire(x, ns.samp_freq, dopp_max=ns.dopp_max,
                  dopp_step=ns.dopp_step, device=device)
    print("PRN  doppler[Hz]  code_phase[samp]  metric")
    for a in acq:
        if a.detected:
            print(f"{a.prn:3d}  {a.doppler:+10.1f}  {a.code_phase:15.1f}"
                  f"  {a.metric:7.1f}")

    if ns.track > 0:
        from gps_sdr_sim_tpu_torch.receiver.pvt import channel_frames

        from gps_sdr_sim_tpu_torch.receiver.navdec import cn0_estimate

        res = track(x, ns.samp_freq, acq, device=device)
        frames = channel_frames(res)  # one decode, shared with --pvt
        print("\nPRN  doppler[Hz]  C/N0[dBHz]  subframes  TOW[s]        week")
        for c, prn in enumerate(res.prns):
            _off, _bits, sbfs = frames[c]
            tows = ",".join(f"{s.tow_sec:.0f}" for s in sbfs) or "-"
            weeks = ",".join(str(s.week) for s in sbfs
                             if s.week is not None) or "-"
            cn0 = cn0_estimate(res.prompt[500:, c])
            print(f"{prn:3d}  {res.doppler[-1, c]:+10.1f}  {cn0:10.1f}"
                  f"  {len(sbfs):9d}  {tows:12s}  {weeks}")

        sol = None
        if ns.pvt:
            from gps_sdr_sim_tpu_torch.constants import R2D
            from gps_sdr_sim_tpu_torch.receiver.pvt import (
                observables, prepare_observables, solve, solve_velocity)
            from gps_sdr_sim_tpu_torch.utils.coord import xyz2llh

            prep = prepare_observables(res, frames)
            obs, ionoutc = observables(res, prep=prep)
            sol = solve(obs, ionoutc, cn0_weighted=ns.weighted)
            llh = xyz2llh(sol.xyz)
            print(f"\nPVT fix ({sol.n_sats} sats, {sol.iterations} iter):")
            print(f"  ECEF  {sol.xyz[0]:.2f} {sol.xyz[1]:.2f} "
                  f"{sol.xyz[2]:.2f}")
            print(f"  LLH   {llh[0] * R2D:.6f} {llh[1] * R2D:.6f} "
                  f"{llh[2]:.1f}")
            print(f"  clock bias {sol.clock_bias * 1e3:.3f} ms, "
                  f"max residual "
                  f"{float(np.max(np.abs(sol.residuals))):.2f} m")
            try:
                vsol = solve_velocity(obs, sol)
            except ValueError:
                vsol = None
            if vsol is not None:
                from gps_sdr_sim_tpu_torch.utils.coord import ecef2neu, ltcmat

                vneu = ecef2neu(vsol.vel, ltcmat(llh))
                print(f"  velocity NEU {vneu[0]:+.3f} {vneu[1]:+.3f} "
                      f"{vneu[2]:+.3f} m/s  speed "
                      f"{float(np.linalg.norm(vsol.vel)):.3f} m/s  "
                      f"clock drift {vsol.clock_drift * 1e9:+.2f} ns/s")

            if ns.pvt_track > 0:
                # Per-epoch single-point track (rtkpost 'single' mode):
                # one independent pseudorange solve per epoch, SOW-stamped
                # from the solution's own reception time.
                step = max(1, int(round(ns.pvt_track * 1000.0)))
                print(f"\n{'SOW':>12s}  {'lat[deg]':>12s} {'lon[deg]':>13s}"
                      f" {'h[m]':>8s}  {'speed[m/s]':>10s}  sats")
                for m in range(1000, res.prompt.shape[0] - 1, step):
                    try:
                        obs_m, _ = observables(res, m=m, prep=prep)
                        s = solve(obs_m, ionoutc, cn0_weighted=ns.weighted)
                        v = solve_velocity(obs_m, s)
                    except (ValueError, np.linalg.LinAlgError):
                        continue
                    lm = xyz2llh(s.xyz)
                    print(f"{s.t_gps:12.3f}  {lm[0] * R2D:12.8f} "
                          f"{lm[1] * R2D:13.8f} {lm[2]:8.2f}  "
                          f"{float(np.linalg.norm(v.vel)):10.3f}  "
                          f"{s.n_sats:4d}")

        if ns.rinex_obs:
            from gps_sdr_sim_tpu_torch.receiver.rinex import write_obs

            with open(ns.rinex_obs, "w") as fp:
                n_ep = write_obs(fp, res, frames=frames,
                                 interval=ns.obs_interval, era=ns.gps_era,
                                 approx_xyz=sol.xyz if sol else None)
            print(f"wrote {n_ep} obs epochs -> {ns.rinex_obs}",
                  file=sys.stderr)
        if ns.rinex_nav:
            from gps_sdr_sim_tpu_torch.receiver.rinex import write_nav

            with open(ns.rinex_nav, "w") as fp:
                n_eph = write_nav(fp, res, frames=frames, era=ns.gps_era)
            print(f"wrote {n_eph} ephemerides -> {ns.rinex_nav}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
