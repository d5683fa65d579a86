"""Command-line interface of the port, flag-compatible with the reference.

Counterpart of gps_sdr_sim_tpu/cli.py: the same getopt-compatible flags,
validation messages, stderr order and output bytes, with synthesis on a
CUDA device (--impl cuda, the default) or the kernel's plain PyTorch
version on any device (--impl torch). The sharding, multi-host and
profiling flags are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import sys
import time

from gps_sdr_sim_tpu.cli import (
    _VALUE_FLAGS,
    _BitsAction,
    _DateTimeAction,
    _SampFreqAction,
    _err,
    _write_json_summary,
    build_config,
)
from gps_sdr_sim_tpu.constants import STATIC_MAX_DURATION, USER_MOTION_SIZE
from gps_sdr_sim_tpu.models.scenario import ScenarioError, build_scenario
from gps_sdr_sim_tpu.utils.cstd import c_atof, c_atoi

# Flags of the JAX CLI that this port does not implement yet.
_NOT_PORTED = ("shard_dir", "shards", "resume", "concat", "multihost",
               "profile")


def _usage():
    print(
        "Usage: gps-sdr-sim-torch [options]\n"
        "Options:\n"
        "  -e <gps_nav>     RINEX navigation file for GPS ephemerides (required)\n"
        "  -u <user_motion> User motion file (dynamic mode)\n"
        "  -g <nmea_gga>    NMEA GGA stream (dynamic mode)\n"
        "  -c <location>    ECEF X,Y,Z in meters (static mode) e.g. 3967283.154,1022538.181,4872414.484\n"
        "  -l <location>    Lat,Lon,Hgt (static mode) e.g. 35.681298,139.766247,10.0\n"
        "  -t <date,time>   Scenario start time YYYY/MM/DD,hh:mm:ss\n"
        "  -T <date,time>   Overwrite TOC and TOE to scenario start time\n"
        f"  -d <duration>    Duration [sec] (dynamic mode max: {USER_MOTION_SIZE / 10.0:.0f}, "
        f"static mode max: {STATIC_MAX_DURATION})\n"
        "  -o <output>      I/Q sampling data file (default: gpssim.bin)\n"
        "  -s <frequency>   Sampling frequency [Hz] (default: 2600000)\n"
        "  -b <iq_bits>     I/Q data format [1/8/16] (default: 16)\n"
        "  -i               Disable ionospheric delay for spacecraft scenario\n"
        "  -v               Show details about simulated channels\n"
        "PyTorch extensions:\n"
        "  --impl <name>       Synthesis: cuda (default; the CUDA kernel) or\n"
        "                      torch (its plain PyTorch version)\n"
        "  --device <dev>      Torch device (default: cuda)\n"
        "  --carrier-phase <m> Carrier NCO: float (default) or fixed\n"
        "                      (the reference's FLOAT_CARR_PHASE=0 build)\n"
        "  --batch-epochs <n>  Epochs per device dispatch (default: 20)\n"
        "  --motion-size <n>   Max user-motion points (default: 3000)\n"
        "  --json-summary <p>  Write a structured run summary to <p>\n",
        file=sys.stderr)


def _merge_values(argv):
    """Join each value flag with its operand (getopt compatibility), as
    gps_sdr_sim_tpu.cli._merge_values does, with this CLI's usage text."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] in _VALUE_FLAGS:
            if i + 1 >= len(argv):
                print(f"option requires an argument -- '{argv[i][1]}'",
                      file=sys.stderr)
                _usage()
                raise SystemExit(1)
            out.append(argv[i] + "=" + argv[i + 1])
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out


def parse_args(argv):
    argv = _merge_values(list(argv))
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("-e", dest="navfile", default="")
    ap.add_argument("-u", dest="umfile", default="")
    ap.add_argument("-g", dest="ggafile", default="")
    ap.add_argument("-c", dest="xyz", default="")
    ap.add_argument("-l", dest="llh", default="")
    ap.add_argument("-t", dest="t0", default="", action=_DateTimeAction)
    ap.add_argument("-T", dest="t0_overwrite", default="",
                    action=_DateTimeAction)
    ap.add_argument("-d", dest="duration", type=c_atof, default=None)
    ap.add_argument("-o", dest="outfile", default="gpssim.bin")
    ap.add_argument("-s", dest="samp_freq", type=c_atof, default=2.6e6,
                    action=_SampFreqAction)
    ap.add_argument("-b", dest="bits", type=c_atoi, default=16,
                    action=_BitsAction)
    ap.add_argument("-i", dest="disable_iono", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("--impl", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--carrier-phase", default="float",
                    choices=("float", "fixed"))
    ap.add_argument("--batch-epochs", type=int, default=20)
    ap.add_argument("--motion-size", type=int, default=USER_MOTION_SIZE)
    ap.add_argument("--json-summary", default="")
    # Accepted only to be refused by name (see main).
    ap.add_argument("--shard-dir", default="")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--concat", action="store_true")
    ap.add_argument("--multihost", default="")
    ap.add_argument("--profile", default="")
    try:
        ns, extras = ap.parse_known_args(argv)
    except SystemExit:
        _usage()
        raise
    for a in extras:
        if a == "--":
            break
        if a.startswith("-") and len(a) > 1:
            print(f"invalid option -- '{a.lstrip('-')[0]}'", file=sys.stderr)
            _usage()
            raise SystemExit(1)
    return ns


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        _usage()
        return 1
    ns = parse_args(argv)
    phases = {"main_start_unix": time.time()}
    for name in _NOT_PORTED:
        if getattr(ns, name) not in ("", None, False):
            _err(f"--{name.replace('_', '-')} is not yet supported by the "
                 f"torch port.")
    cfg = build_config(ns)
    from gps_sdr_sim_tpu_torch.runner import resolve_device

    try:  # fail before any work: no silent fallback to the CPU
        device = resolve_device(ns.impl, ns.device)
    except (ValueError, RuntimeError) as e:
        _err(f"{e}.")

    if cfg.static_xyz is not None or (not cfg.motion_file
                                      and not cfg.nmea_file):
        print("Using static location mode.", file=sys.stderr)

    t_ph = time.time()
    try:
        scn = build_scenario(cfg)
    except ScenarioError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    phases["build_scenario_s"] = time.time() - t_ph

    if cfg.verbose and scn.ionoutc_file.vflg:
        # The reference dumps the file's values BEFORE any -T overwrite.
        io = scn.ionoutc_file
        print(f"  {io.alpha0:12.3e} {io.alpha1:12.3e} {io.alpha2:12.3e} "
              f"{io.alpha3:12.3e}", file=sys.stderr)
        print(f"  {io.beta0:12.3e} {io.beta1:12.3e} {io.beta2:12.3e} "
              f"{io.beta3:12.3e}", file=sys.stderr)
        print(f"   {io.A0:19.11e} {io.A1:19.11e}  {io.tot:9d} {io.wnt:9d}",
              file=sys.stderr)
        print(f"{io.dtls:6d}", file=sys.stderr)

    t0, g0 = scn.t0, scn.g0
    print(f"Start time = {t0.y:4d}/{t0.m:02d}/{t0.d:02d},"
          f"{t0.hh:02d}:{t0.mm:02d}:{t0.sec:02.0f} ({g0.week}:{g0.sec:.0f})",
          file=sys.stderr)
    print(f"Duration = {scn.numd / 10.0:.1f} [sec]", file=sys.stderr)

    # The reference opens the output file (gpssim.c:2100-2111) BEFORE the
    # channel table print (:2131-2136).
    if cfg.out_file == "-":
        fp, close_fp = sys.stdout.buffer, False
    else:
        try:
            fp, close_fp = open(cfg.out_file, "wb"), True
        except OSError:
            print("ERROR: Failed to open output file.", file=sys.stderr)
            return 1

    tables = scn.channel_tables if cfg.verbose else scn.channel_tables[:1]
    for _iumd, rows in tables:
        for prn, az, el, d, iono in rows:
            print(f"{prn:02d} {az:6.1f} {el:5.1f} {d:11.1f} {iono:5.1f}",
                  file=sys.stderr)

    return _run(ns, scn, fp, close_fp, device, phases)


def _run(ns, scn, fp, close_fp, device, phases) -> int:
    from gps_sdr_sim_tpu_torch.runner import run_simulation

    t_start = time.time()
    try:
        stats = run_simulation(scn, fp, batch_epochs=ns.batch_epochs,
                               impl=ns.impl, device=device)
    finally:
        if close_fp:
            fp.close()

    print("\nDone!", file=sys.stderr)
    print(f"Process time = {time.time() - t_start:.1f} [sec]", file=sys.stderr)
    if stats.wall_seconds:
        rt = stats.samples_per_second / scn.samp_freq
        print(f"Throughput = {stats.samples_per_second / 1e6:.1f} Msamples/s "
              f"({rt:.1f}x real time)", file=sys.stderr)
    if ns.json_summary:
        _write_json_summary(ns.json_summary, stats, scn.samp_freq, phases)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
