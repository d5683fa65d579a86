"""Scaling sweep: sharded synthesis throughput over growing device meshes.

Counterpart of the repository's root bench_scaling.py. Measures samples/s
of the sharded synthesis (parallel/shard.py) on meshes of 1, 2, 4, ...
devices and reports the efficiency against the one-device rate. Impls:

  closed    the closed form in plain torch (synth_batch_sharded; root
            impl xla), on any device;
  cuda      the row kernel (synth_rows_sharded; root impl pallas), on a
            card;
  cuda-wire the wire kernel (synth_epochs_sharded; root impl
            pallas-wire), on a card.

Meshes take the cards of --device's type (one device for cpu); with
--repeat-devices 1,2,4 they are meshes of those sizes that repeat the
first device, and each row says how many distinct devices it used. Each
time is a host clock around the sharded call, a synchronize of every card
of the mesh and a checksum read back to the host. Prints one JSON line per mesh, with
the device's type, name, count and power limit.

  python -m gps_sdr_sim_tpu_torch.tools.bench_scaling --device cpu
  python -m gps_sdr_sim_tpu_torch.tools.bench_scaling --impl cuda
  python -m gps_sdr_sim_tpu_torch.tools.bench_scaling --repeat-devices 1,2,4

--multihost 1,2 instead runs the CLI in 1, then 2 processes joined by a
torch.distributed gloo group over localhost, each writing its time shards
(parallel/writer.py), and reports wall-time scaling of that path.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.plan import plan_batch, plan_epochs
from gps_sdr_sim_tpu_torch.parallel import (
    make_mesh,
    synth_batch_sharded,
    synth_epochs_sharded,
    synth_rows_sharded,
)
from gps_sdr_sim_tpu_torch.parallel.mesh import local_devices
from gps_sdr_sim_tpu_torch.runner import EpochCountError, check_epoch_count
from gps_sdr_sim_tpu_torch.testing import NAV, ROOT, TOKYO

IMPLS = ("closed", "cuda", "cuda-wire")


def device_fields(device_type: str) -> dict:
    """The device's type, name, count and power limit (the card's as
    nvidia-smi gives them; no name or limit for the CPU)."""
    if device_type == "cuda":
        from gps_sdr_sim_tpu_torch.tools.card import card_line

        name, _, limit = card_line().partition(", ")
        return {"device_type": "cuda", "device_name": name,
                "device_count": torch.cuda.device_count(),
                "power_limit": limit}
    return {"device_type": device_type, "device_name": None,
            "device_count": len(local_devices(device_type)),
            "power_limit": None}


def sweep(impl: str = "closed", device="cuda", epochs_per_device: int = 8,
          samp_freq: float = 2.6e6, chan_axis: int = 1, repeats: int = 3,
          repeat_devices=None) -> list:
    """The in-process sweep; returns its rows. repeat_devices: a list of
    mesh sizes over the first device repeated, instead of 1, 2, 4, ... over
    the distinct devices. Raises ValueError for a cuda impl on another
    device type or fewer than one epoch per device, RuntimeError for a
    CUDA device that is not available."""
    check_epoch_count(epochs_per_device, "epochs_per_device")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device_type = torch.device(device).type
    if impl.startswith("cuda") and device_type != "cuda":
        raise ValueError(f"impl '{impl}' runs a CUDA kernel and needs a "
                         f"CUDA device, got '{device}'")
    devices = local_devices(device_type)
    if repeat_devices:
        sizes = list(repeat_devices)
    else:
        sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]

    max_epochs = epochs_per_device * max(sizes)
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO,
        duration=0.1 * (max_epochs + 1), samp_freq=samp_freq))
    seg = scn.segments[0]
    n_out = scn.iq_buff_size
    fields = device_fields(device_type)

    rows = []
    base_rate = None
    for n in sizes:
        if n > 1 and n % chan_axis:
            continue
        # n = 1 always runs on a (1, 1) mesh, so efficiency_vs_1dev is
        # anchored to the one-device rate even for chan-axis sweeps.
        n_chan = chan_axis if n > 1 else 1
        mesh_devs = [devices[0]] * n if repeat_devices else devices[:n]
        mesh = make_mesh(n // n_chan, n_chan, mesh_devs)
        b = min(epochs_per_device * n, seg.n_epochs)
        if impl == "cuda-wire":
            batch, fn = plan_epochs(seg, 0, b, scn.delt), synth_epochs_sharded
        else:
            batch = plan_batch(seg, 0, b, n_out, scn.delt)
            fn = synth_rows_sharded if impl == "cuda" else synth_batch_sharded

        def run():
            pieces = fn(batch, n_out, mesh)
            if device_type == "cuda":
                for dev in set(mesh_devs):
                    torch.cuda.synchronize(dev)
            return sum(int(p.to(torch.int64).sum()) for p in pieces)

        run()  # warm-up: builds, pinned buffers, caches
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        rate = b * n_out / best
        if base_rate is None:
            base_rate = rate
        rows.append({
            "metric": "scaling_samples_per_sec", "impl": impl,
            "devices": n, "mesh": list(mesh.shape.items()),
            "distinct_devices": len(set(mesh_devs)),
            "epochs": b, "seconds": best,
            "value": round(rate / 1e6, 3), "unit": "Msamples_per_sec",
            "efficiency_vs_1dev": round(rate / (base_rate * n), 3),
            **fields})
    return rows


def multihost_sweep(proc_counts, impl: str = "closed", device="cpu",
                    duration: float = 8.0, samp_freq: float = 1.0e6,
                    batch_epochs: int = 10) -> list:
    """Wall-time scaling of the multi-process path: for each count N, the
    CLI in N processes joined by gloo over localhost (one process without
    --multihost for N = 1), each writing its time shards, rank 0
    concatenating. The CLI impl is the sweep's (cuda-wire: the CLI's
    cuda). Efficiency is wall-time speedup against the first point;
    synth_wall_s is the longest synthesis loop of the processes (their
    --json-summary), the rest start-up and teardown."""
    cli_impl = {"closed": "closed", "cuda": "cuda", "cuda-wire": "cuda"}[impl]
    args = ["-e", str(NAV), "-l", "35.681298,139.766247,10.0",
            "-d", f"{duration:g}", "-s", f"{samp_freq:.0f}", "--impl",
            cli_impl, "--device", str(device), "--batch-epochs",
            str(batch_epochs)]
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=duration,
        samp_freq=samp_freq))
    n_samples = scn.total_samples
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "gps_sdr_sim_tpu_torch.cli"]
    fields = device_fields(torch.device(device).type)

    rows = []
    base = base_steady = None
    for n in proc_counts:
        with tempfile.TemporaryDirectory() as td:
            out = pathlib.Path(td) / "out.bin"
            t0 = time.time()
            if n == 1:
                argvs = [args + ["-o", str(out), "--json-summary",
                                 f"{td}/sum0.json"]]
            else:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                argvs = [args + ["-o", str(out), "--shard-dir", f"{td}/sh",
                                 "--shards", str(2 * n), "--concat",
                                 "--json-summary", f"{td}/sum{pid}.json",
                                 "--multihost", f"127.0.0.1:{port},{pid},{n}"]
                         for pid in range(n)]
            procs = [subprocess.Popen(cmd + a, cwd=ROOT, env=env,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE)
                     for a in argvs]
            try:
                for p in procs:
                    _, err = p.communicate(timeout=1200)
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"CLI process exited {p.returncode}:\n"
                            f"{err.decode()[-2000:]}")
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
            wall = time.time() - t0
            if out.stat().st_size != n_samples * 4:
                raise RuntimeError(f"output holds {out.stat().st_size} "
                                   f"bytes, expected {n_samples * 4}")
            sums = [json.loads((pathlib.Path(td) / f"sum{pid}.json")
                               .read_text()) for pid in range(n)]
        synth_wall = max(s["wall_seconds"] for s in sums)
        ph = [s.get("phases", {}) for s in sums]
        breakdown = {
            "spawn_import_s": max(p.get("main_start_unix", t0) - t0
                                  for p in ph),
            **{k: max(p.get(k, 0.0) for p in ph) for k in (
                "dist_init_s", "build_scenario_s", "shard_sync_s",
                "concat_s")}}
        breakdown["residual_s"] = wall - synth_wall - sum(breakdown.values())
        rate, steady = n_samples / wall, n_samples / synth_wall
        if base is None:
            base, base_steady = rate, steady
        rows.append({
            "metric": "multihost_scaling_samples_per_sec", "impl": cli_impl,
            "processes": n, "wall_s": wall, "synth_wall_s": synth_wall,
            "startup_teardown_s": wall - synth_wall,
            "startup_breakdown": breakdown,
            "value": round(rate / 1e6, 3), "unit": "Msamples_per_sec",
            "steady_msamples_per_sec": round(steady / 1e6, 3),
            "efficiency_vs_1proc": round(rate / (base * n), 3),
            "steady_efficiency_vs_1proc": round(
                steady / (base_steady * n), 3),
            **fields})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.bench_scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", default="closed", choices=IMPLS)
    ap.add_argument("--device", default="cuda",
                    help="device type of the meshes (default: cuda)")
    ap.add_argument("--epochs-per-device", type=int, default=8)
    ap.add_argument("--samp-freq", type=float, default=None,
                    help="sample rate (default: 2.6e6; 1e6 with "
                         "--multihost)")
    ap.add_argument("--chan-axis", type=int, default=1,
                    help="devices on the channel axis (rest go to time)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--repeat-devices", default="",
                    help="comma list of mesh sizes (e.g. 1,2,4) built by "
                         "repeating the first device")
    ap.add_argument("--multihost", default="",
                    help="comma list of process counts (e.g. 1,2): run the "
                         "CLI in that many gloo-joined processes instead")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="seconds of signal per --multihost point")
    ap.add_argument("--json", default="",
                    help="also write the rows to this file")
    ns = ap.parse_args(argv)

    if (err := synth.refuse_samp_freq(ns.samp_freq)) is not None:
        print(err, file=sys.stderr)
        return 1
    if ns.multihost:
        rows = multihost_sweep(
            [int(v) for v in ns.multihost.split(",")], ns.impl, ns.device,
            ns.duration, ns.samp_freq or 1.0e6)
    else:
        try:
            rows = sweep(ns.impl, ns.device, ns.epochs_per_device,
                         ns.samp_freq or 2.6e6, ns.chan_axis, ns.repeats,
                         [int(v) for v in ns.repeat_devices.split(",")]
                         if ns.repeat_devices else None)
        except EpochCountError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
    for row in rows:
        print(json.dumps(row), flush=True)
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(
            {"metric": "scaling_sweep", "host_cpus": os.cpu_count(),
             "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
