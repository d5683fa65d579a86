"""Command-line interface of the port, flag-compatible with the reference.

Counterpart of gps_sdr_sim_tpu/cli.py: the same getopt-compatible flags,
validation messages, stderr order and output bytes, with synthesis on a
CUDA device (--impl cuda, the default), the kernel's plain PyTorch version
on any device (--impl torch), the closed form from a DeviceBatch in plain
torch on any device (--impl closed, the counterpart of the JAX CLI's xla),
or any of them sharded over every local device of --device's type (--impl
cuda-sharded / torch-sharded / closed-sharded). --shard-dir writes
time-shard files and a manifest (with --shards, --resume and --concat), and
--multihost joins a torch.distributed (gloo) group whose processes write
disjoint shards. --profile DIR writes a torch.profiler trace of the run (CPU
activity, and the card's kernels when --device is a CUDA device) into DIR
as a Chrome trace.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from gps_sdr_sim_tpu_torch.constants import (
    R2D,
    STATIC_MAX_DURATION,
    USER_MOTION_SIZE,
)
from gps_sdr_sim_tpu_torch.models.scenario import (
    ScenarioConfig,
    ScenarioError,
    build_scenario,
)
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.parallel.writer import (
    concat_shards,
    process_count,
    process_index,
    run_simulation_sharded,
)
from gps_sdr_sim_tpu_torch.runner import IMPLS, resolve_device, run_simulation
from gps_sdr_sim_tpu_torch.utils.coord import llh2xyz
from gps_sdr_sim_tpu_torch.utils.cstd import c_atof, c_atoi, c_sscanf_doubles
from gps_sdr_sim_tpu_torch.utils.gpstime import DateTime


def _sscanf3(s: str):
    """sscanf(s, "%lf,%lf,%lf") — stop at the first failed conversion,
    leaving later fields at zero (the reference's variables are stack
    values; zero is the deterministic stand-in, gpssim.c:1774,1780)."""
    vals = c_sscanf_doubles(s, 3)
    return vals + [0.0] * (3 - len(vals))


def _err(msg: str):
    print(f"ERROR: {msg}", file=sys.stderr)
    raise SystemExit(1)


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
        "  --impl <name>       Synthesis: cuda (default; the CUDA kernel),\n"
        "                      torch (its plain PyTorch version), closed\n"
        "                      (the closed form in plain torch), or\n"
        "                      cuda-sharded/torch-sharded/closed-sharded\n"
        "                      (all local devices of --device's type)\n"
        "  --device <dev>      Torch device (default: cuda)\n"
        "  --carrier-phase <m> Carrier NCO: float (default) or fixed\n"
        "                      (the reference's FLOAT_CARR_PHASE=0 build)\n"
        "  --batch-epochs <n>  Epochs per device dispatch (default: 20)\n"
        "  --motion-size <n>   Max user-motion points (default: 3000)\n"
        "  --json-summary <p>  Write a structured run summary to <p>\n"
        "  --shard-dir <dir>   Write time-shard files + manifest to <dir>\n"
        "                      instead of a single -o file\n"
        "  --shards <n>        Number of time shards (default: one per process)\n"
        "  --resume            Skip shards already complete in --shard-dir\n"
        "  --concat            After sharding, assemble -o from the shards\n"
        "  --multihost <spec>  coord_addr:port,process_id,num_processes --\n"
        "                      join a torch.distributed (gloo) group\n"
        "  --profile <dir>     Write a torch.profiler trace of the run\n",
        file=sys.stderr)


_VALUE_FLAGS = ("-e", "-u", "-g", "-c", "-l", "-t", "-T", "-d", "-o", "-s",
                "-b")



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


# Per-occurrence validation, matching the reference's getopt loop: each
# -s/-b/-t/-T occurrence is validated AT ITS ARGV POSITION
# (gpssim.c:1788-1833), so `-s 999 -s 2600000` errors on the first -s and
# `-t garbage -d 90000` reports the date error, not the duration error
# (duration is only checked after the loop, gpssim.c:1869-1874).
class _SampFreqAction(argparse.Action):
    def __call__(self, parser, ns, value, option_string=None):
        if value < synth.MIN_SAMP_FREQ:
            _err("Invalid sampling frequency.")
        setattr(ns, self.dest, value)


class _BitsAction(argparse.Action):
    def __call__(self, parser, ns, value, option_string=None):
        if value not in (1, 8, 16):
            _err("Invalid I/Q data format.")
        setattr(ns, self.dest, value)


class _AtLeastOneAction(argparse.Action):
    """--batch-epochs and --shards: a count below 1 is an error here (the
    JAX CLI loops forever on --batch-epochs 0 and divides by zero on
    --shards 0)."""

    def __call__(self, parser, ns, value, option_string=None):
        if value < 1:
            _err(f"{option_string} must be at least 1.")
        setattr(ns, self.dest, value)


class _DateTimeAction(argparse.Action):
    def __call__(self, parser, ns, value, option_string=None):
        if not (option_string == "-T" and value.startswith("now")):
            _parse_datetime(value)  # errors like the reference's 't' case
        setattr(ns, self.dest, value)


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
    ap.add_argument("--impl", default="cuda", choices=IMPLS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--carrier-phase", default="float",
                    choices=("float", "fixed"))
    ap.add_argument("--batch-epochs", type=int, default=20,
                    action=_AtLeastOneAction)
    ap.add_argument("--motion-size", type=int, default=USER_MOTION_SIZE)
    ap.add_argument("--json-summary", default="")
    ap.add_argument("--shard-dir", default="")
    ap.add_argument("--shards", type=int, default=None,
                    action=_AtLeastOneAction)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--concat", action="store_true")
    ap.add_argument("--multihost", default="", metavar="COORD:PORT,ID,N")
    ap.add_argument("--profile", default="", metavar="DIR")
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


def _parse_datetime(s: str) -> DateTime:
    t = DateTime()
    try:
        date, clock = s.split(",")
        y, m, d = date.split("/")
        hh, mm, sec = clock.split(":")
        t.y, t.m, t.d = int(y), int(m), int(d)
        t.hh, t.mm, t.sec = int(hh), int(mm), float(sec)
    except ValueError:
        _err("Invalid date and time.")
    if (t.y <= 1980 or not 1 <= t.m <= 12 or not 1 <= t.d <= 31
            or not 0 <= t.hh <= 23 or not 0 <= t.mm <= 59
            or not 0.0 <= t.sec < 60.0):
        _err("Invalid date and time.")
    t.sec = float(int(t.sec))  # C: floor(t0.sec) (gpssim.c:1833)
    return t


def _write_json_summary(path: str, stats, samp_freq: float,
                        phases: dict | None = None) -> None:
    import json

    d = stats.summary(samp_freq)
    if phases:
        # Wall-clock attribution of everything OUTSIDE the synthesis loop
        # (process spawn/import can be derived by the caller from
        # main_start_unix vs its own launch timestamp). SCALING_r04 weak
        # #5: the multihost startup bucket was one opaque number.
        d["phases"] = {k: round(v, 3) for k, v in phases.items()}
    with open(path, "w") as jfp:
        json.dump(d, jfp, indent=1)


def build_config(ns) -> ScenarioConfig:
    # -s/-b/-t/-T were already validated per occurrence at parse time
    # (argv order, see the _*Action classes); only the post-loop checks of
    # gpssim.c:1856-1874 remain here, in the reference's order.
    if not ns.navfile:
        _err("GPS ephemeris file is not specified.")

    static_xyz = None
    if ns.xyz:
        static_xyz = np.array(_sscanf3(ns.xyz))
    elif ns.llh:
        lat, lon, hgt = _sscanf3(ns.llh)
        static_xyz = llh2xyz(np.array([lat / R2D, lon / R2D, hgt]))

    # Duration validation mirrors gpssim.c:1869-1874 and must precede the
    # "Using static location mode." print (the reference validates at
    # :1869, prints at :1914).
    static_mode = static_xyz is not None or not (ns.umfile or ns.ggafile)
    duration = (ns.duration if ns.duration is not None
                else ns.motion_size / 10.0)
    max_dur = (STATIC_MAX_DURATION if static_mode
               else ns.motion_size / 10.0)
    if duration < 0.0 or duration > max_dur:
        _err("Invalid duration.")

    t0 = None
    timeoverwrite = False
    if ns.t0_overwrite:
        timeoverwrite = True
        if ns.t0_overwrite.startswith("now"):
            gmt = time.gmtime()
            t0 = DateTime(gmt.tm_year, gmt.tm_mon, gmt.tm_mday, gmt.tm_hour,
                          gmt.tm_min, float(gmt.tm_sec))
        else:
            t0 = _parse_datetime(ns.t0_overwrite)
    elif ns.t0:
        t0 = _parse_datetime(ns.t0)

    return ScenarioConfig(
        nav_file=ns.navfile,
        out_file=ns.outfile,
        samp_freq=ns.samp_freq,
        data_format=ns.bits,
        static_xyz=static_xyz,
        motion_file=ns.umfile or None,
        nmea_file=ns.ggafile or None,
        duration=ns.duration,
        t0=t0,
        timeoverwrite=timeoverwrite,
        iono_enable=not ns.disable_iono,
        verbose=ns.verbose,
        max_motion_points=ns.motion_size,
        carrier_phase_mode=ns.carrier_phase,
    )


def _init_multihost(spec: str, shard_dir: str, phases: dict) -> None:
    """--multihost coord:port,id,n: join a torch.distributed gloo group of
    n processes before any work. Epochs are independent, so no tensor
    crosses processes: the group gives each process its rank (which shards
    it writes) and the barrier before --concat. Each process synthesizes
    on its own --device."""
    t_ph = time.time()
    try:
        coord, pid, nproc = spec.rsplit(",", 2)
        rank, world = int(pid), int(nproc)
    except ValueError as e:
        _err(f"Invalid --multihost spec or coordination failure: {e}")
    if not shard_dir:
        _err("--multihost requires --shard-dir (per-host shard files).")
    try:
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                rank=rank, world_size=world)
    except (ValueError, RuntimeError) as e:
        _err(f"Invalid --multihost spec or coordination failure: {e}")
    phases["dist_init_s"] = time.time() - t_ph


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        _usage()
        return 1
    ns = parse_args(argv)
    phases = {"main_start_unix": time.time()}
    if not ns.multihost:
        return _main(ns, phases)
    try:
        _init_multihost(ns.multihost, ns.shard_dir, phases)
        return _main(ns, phases)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(ns, phases) -> int:
    cfg = build_config(ns)
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
    # channel table print (:2131-2136). Shard mode writes no single file.
    fp, close_fp = None, False
    if not ns.shard_dir:
        if cfg.out_file == "-":
            fp = sys.stdout.buffer
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

    if not ns.profile:
        return _run_either(ns, cfg, scn, fp, close_fp, device, phases)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        return _run_either(ns, cfg, scn, fp, close_fp, device, phases)
    finally:
        prof.stop()
        os.makedirs(ns.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            ns.profile, f"gps-sdr-sim-torch.{os.getpid()}.pt.trace.json"))
        print(f"profiler trace written to {ns.profile}", file=sys.stderr)


def _run_either(ns, cfg, scn, fp, close_fp, device, phases) -> int:
    if ns.shard_dir:
        return _run_sharded(ns, cfg, scn, device, phases)
    return _run(ns, scn, fp, close_fp, device, phases)


def _run(ns, scn, fp, close_fp, device, phases) -> int:
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


def _run_sharded(ns, cfg, scn, device, phases) -> int:
    """--shard-dir: time-shard files + manifest, then --concat's file."""
    t_start = time.time()
    try:
        _manifest, stats = run_simulation_sharded(
            scn, ns.shard_dir, n_shards=ns.shards,
            batch_epochs=ns.batch_epochs, impl=ns.impl, resume=ns.resume,
            device=device)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if ns.concat:
        t_ph = time.time()
        if process_count() > 1:
            # Wait for every process's shards; then one process assembles.
            dist.barrier()
        phases["shard_sync_s"] = time.time() - t_ph
        t_ph = time.time()
        if process_index() == 0:
            try:
                concat_shards(ns.shard_dir, cfg.out_file)
            except (ValueError, OSError) as e:
                print(f"ERROR: {e}", file=sys.stderr)
                return 1
        phases["concat_s"] = time.time() - t_ph
    if ns.json_summary:
        _write_json_summary(ns.json_summary, stats, scn.samp_freq, phases)
    print("\nDone!", file=sys.stderr)
    print(f"Process time = {time.time() - t_start:.1f} [sec]",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
