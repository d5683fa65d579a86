"""Deep-run oracle verification: sampled-block comparison of an hours-long
static run against the C reference, without holding its output on disk.

Counterpart of the repository's root tools/deepcheck.py, on the port's
runner. The committed goldens cover 0.3 s; this script verifies multi-hour
behavior (the 30 s nav refresh cadence and repeated 2 h ephemeris-set
advances, gpssim.c:2307-2332) by streaming the oracle's stdout (-o -)
through a sampler that keeps only selected epoch blocks, then synthesizing
exactly those blocks with run_epoch_range (any epoch range is independently
computable) and diffing per block.

    python -m gps_sdr_sim_tpu_torch.tools.deepcheck --duration 23400 \\
        --samp-freq 1e6 --block-epochs 20 [--impl cuda] [--device cuda] \\
        [--reference DIR] [--json out.json]

The oracle is built from the C reference's gpssim.c and gpssim.h in
--reference (default: $GPS_SDR_SIM_REFERENCE, else the directory
`reference` inside the repository); without them the script exits 1 and
names the directory it looked in.

Block placement (pick_blocks): one block at the start, one right after
every expected ephemeris-set advance, plus evenly spaced filler blocks,
the regions where a cadence bug would first corrupt the stream. The day
run (tools/dayrun.py) samples with the same function.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from gps_sdr_sim_tpu_torch.constants import R2D
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.runner import run_epoch_range
from gps_sdr_sim_tpu_torch.testing import NAV, ROOT
from gps_sdr_sim_tpu_torch.utils.coord import llh2xyz

REF = pathlib.Path(os.environ.get("GPS_SDR_SIM_REFERENCE",
                                  ROOT / "reference"))
LOC = "35.681298,139.766247,10.0"
REF_SOURCES = ("gpssim.c", "gpssim.h")


class ReferenceMissing(RuntimeError):
    """The C reference cannot be built: its sources are not where the
    oracle is built from, or gcc is not on PATH."""


def static_config(samp_freq: float, duration: float, data_format: int = 16):
    """The sampled runs' scenario: the bundled ephemerides, static at LOC."""
    lat, lon, hgt = (float(v) for v in LOC.split(","))
    return ScenarioConfig(
        nav_file=str(NAV), samp_freq=samp_freq, duration=duration,
        data_format=data_format,
        static_xyz=llh2xyz(np.array([lat / R2D, lon / R2D, hgt])))


def oracle_command(oracle, duration: float, samp_freq: float,
                   fmt: int = 16) -> list:
    """The C reference's command line for the static run, writing to
    stdout."""
    return [str(oracle), "-e", str(NAV), "-l", LOC, "-d", str(duration),
            "-s", str(int(samp_freq)), "-b", str(fmt), "-o", "-"]


def build_oracle(tmp: pathlib.Path, ref: pathlib.Path = None,
                 fixed: bool = False) -> pathlib.Path:
    """Compile the C reference in `tmp` (made if absent); raises
    ReferenceMissing if `ref` (default REF) lacks its sources or gcc is
    not on PATH. With `fixed`, gpssim.h's FLOAT_CARR_PHASE is commented
    out: the 32-bit fixed-point carrier NCO, the oracle of --carrier-phase
    fixed. Every tool that runs the C reference builds it here."""
    tmp, ref = pathlib.Path(tmp), REF if ref is None else pathlib.Path(ref)
    missing = [f for f in REF_SOURCES if not (ref / f).is_file()]
    if missing:
        raise ReferenceMissing(
            f"the C reference is not in {ref} (missing "
            f"{', '.join(missing)}); pass --reference DIR or set "
            f"GPS_SDR_SIM_REFERENCE to the directory holding gpssim.c and "
            f"gpssim.h")
    if shutil.which("gcc") is None:
        raise ReferenceMissing(f"gcc is not on PATH, so the C reference in "
                               f"{ref} cannot be built")
    tmp.mkdir(parents=True, exist_ok=True)
    shutil.copy(ref / "gpssim.c", tmp / "gpssim.c")
    header = (ref / "gpssim.h").read_bytes()
    if fixed:
        header = header.replace(b"#define FLOAT_CARR_PHASE",
                                b"// #define FLOAT_CARR_PHASE")
    (tmp / "gpssim.h").write_bytes(header)
    subprocess.run(["gcc", "gpssim.c", "-lm", "-O3", "-o", "gps-sdr-sim"],
                   cwd=tmp, check=True, capture_output=True)
    return tmp / "gps-sdr-sim"


def pick_blocks(scn, block_epochs: int, n_filler: int):
    """Epoch ranges to sample: after each ephemeris-set advance + filler."""
    total = scn.n_output_epochs
    starts = {0}
    # Segments begin right after each 30 s boundary; set advances happen at
    # boundaries where grx crosses (toc - 1 h) of the next set: sample the
    # first block of every hour-and-a-bit to be sure each advance region is
    # covered, plus evenly spaced filler.
    for h in range(1, int(scn.numd * 0.1 // 3600) + 1):
        starts.add(min(h * 36000, total - block_epochs))
    for k in range(1, n_filler + 1):
        starts.add(k * (total - block_epochs) // (n_filler + 1))
    return sorted((s, min(s + block_epochs, total)) for s in starts
                  if s < total)


def stream_sample(cmd, ranges_bytes, total_bytes):
    """Run `cmd`, keep only [lo, hi) byte ranges of its stdout."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, bufsize=1 << 20)
    keep = {lo: bytearray() for lo, _hi in ranges_bytes}
    ranges = sorted(ranges_bytes)
    pos = 0
    ri = 0
    chunk_bytes = 1 << 22
    while True:
        chunk = proc.stdout.read(chunk_bytes)
        if not chunk:
            break
        end = pos + len(chunk)
        while ri < len(ranges) and ranges[ri][1] <= pos:
            ri += 1
        for lo, hi in ranges[ri:]:
            if lo >= end:
                break
            a, b = max(lo, pos), min(hi, end)
            if a < b:
                keep[lo] += chunk[a - pos:b - pos]
        pos = end
    proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"oracle exited {proc.returncode}")
    if pos != total_bytes:
        raise RuntimeError(f"oracle wrote {pos} bytes, expected {total_bytes}")
    return keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.deepcheck",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=23400.0,
                    help="seconds; 23400 = 6.5 h, crossing 3 set advances")
    ap.add_argument("--samp-freq", type=float, default=1.0e6)
    ap.add_argument("--block-epochs", type=int, default=20)
    ap.add_argument("--filler-blocks", type=int, default=6)
    ap.add_argument("--impl", default="cuda",
                    help="run_epoch_range impl (default: cuda, the kernel; "
                         "torch or closed run plain torch)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default=str(REF),
                    help="directory of the C reference's gpssim.c/.h")
    ap.add_argument("--json", default="")
    ns = ap.parse_args(argv)
    if (err := synth.refuse_samp_freq(ns.samp_freq)) is not None:
        print(err, file=sys.stderr)
        return 1
    if ns.block_epochs < 1:
        print("ERROR: --block-epochs must be at least 1.", file=sys.stderr)
        return 1

    with tempfile.TemporaryDirectory() as td:
        try:
            oracle = build_oracle(pathlib.Path(td), ns.reference)
        except ReferenceMissing as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1

        t0 = time.time()
        scn = build_scenario(static_config(ns.samp_freq, ns.duration))
        print(f"scenario: {scn.n_output_epochs} epochs, "
              f"{len(scn.segments)} segments, build {time.time() - t0:.1f} s",
              file=sys.stderr)

        blocks = pick_blocks(scn, ns.block_epochs, ns.filler_blocks)
        bpe = scn.iq_buff_size * 4  # SC16 bytes per epoch
        total_bytes = scn.n_output_epochs * bpe
        ranges_bytes = [(lo * bpe, hi * bpe) for lo, hi in blocks]
        print(f"sampling {len(blocks)} blocks of {ns.block_epochs} epochs "
              f"from {total_bytes / 1e9:.1f} GB of oracle output",
              file=sys.stderr)

        t0 = time.time()
        kept = stream_sample(oracle_command(oracle, ns.duration,
                                            ns.samp_freq),
                             ranges_bytes, total_bytes)
        print(f"oracle run: {time.time() - t0:.1f} s", file=sys.stderr)

    report = []
    worst = {"frac": 0.0, "max": 0, "big": 0}
    for (lo, hi), (blo, _bhi) in zip(blocks, ranges_bytes):
        buf = io.BytesIO()
        run_epoch_range(scn, buf, lo, hi, batch_epochs=ns.block_epochs,
                        impl=ns.impl, device=ns.device, log=lambda s: None)
        a = np.frombuffer(buf.getvalue(), np.int16).astype(np.int32)
        b = np.frombuffer(bytes(kept[blo]), np.int16).astype(np.int32)
        if a.size != b.size:
            raise RuntimeError(f"block [{lo}, {hi}): {a.size} values "
                               f"synthesized, {b.size} from the oracle")
        d = np.abs(a - b)
        frac = float(np.count_nonzero(d) / d.size)
        entry = {
            "epochs": [lo, hi], "t_start_s": round(lo * 0.1, 1),
            "samples": int(d.size), "mismatch_fraction": round(frac, 8),
            "max_delta": int(d.max(initial=0)),
            "big": int(np.count_nonzero(d > 8)),
        }
        report.append(entry)
        worst["frac"] = max(worst["frac"], frac)
        worst["max"] = max(worst["max"], entry["max_delta"])
        worst["big"] += entry["big"]
        print(json.dumps(entry), file=sys.stderr)

    ok = worst["frac"] <= 1e-4 and worst["max"] <= 8 and worst["big"] == 0
    summary = {
        "metric": "deep_oracle_sampled_blocks",
        "duration_s": ns.duration, "samp_freq": ns.samp_freq,
        "impl": ns.impl, "device": ns.device,
        "blocks": len(blocks), "worst_mismatch_fraction": worst["frac"],
        "worst_max_delta": worst["max"], "big_mismatches": worst["big"],
        "pass": ok, "detail": report,
    }
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "detail"}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
