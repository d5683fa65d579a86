#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gps_sdr_sim_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each printing one line of findings (any
failure raises and exits non-zero):

 1. environment: card name and power limit, CUDA, nvcc, triton;
 2. build csrc/synth.cu with nvcc for sm_90a (timed as set-up);
 3. the kernel against its plain PyTorch version on the card, word for
    word: four sample rates x three formats, the highalt16 and staticfix16
    configurations, and seeded random wires;
 4. the 11 C-reference IQ goldens through run_simulation(impl="cuda");
 5. the CLI end to end as a subprocess, checked against golden static16;
 6. the canonical workload (circle.csv, 300 s, 2.6 Msps, SC16/SC08/SC01)
    through run_simulation(impl="cuda"): (sum, nonzero) must equal
    tests/golden/bench_checksum.txt exactly; the median of three passes
    into a null sink gives the real-time factor;
 7. kernel and plain-version times on one 100-epoch 2.6 Msps batch.

The line before the last is the kernel report; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCE = "gps_sdr_sim_tpu_torch/csrc/synth.cu"
KERNEL_REPLACES = "gps_sdr_sim_tpu/ops/synth_pallas.py:171"
RATES = (1.0e6, 1310720.0, 1331200.0, 2.6e6)
FORMATS = (16, 8, 1)


def say(line: str) -> None:
    print(line, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_env(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False")
    card = card_line()
    say(card)
    from gps_sdr_sim_tpu_torch.ops.synth_cuda import nvcc_path

    try:
        nvcc = subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[-1]
    except (RuntimeError, OSError) as e:
        nvcc = f"unavailable ({e})"
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = "not importable"
    say(f"phase 1 env: card={card!r} devices={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"nvcc={nvcc!r} triton={tri}")
    return card


def phase_build() -> None:
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    t = time.perf_counter()
    lib = synth_cuda.build(verbose=True)
    synth_cuda.load()
    say(f"phase 2 build: {lib.name} in {time.perf_counter() - t:.2f} s")


def phase_kernel_vs_plain(torch, dev) -> int:
    """Returns the largest |kernel - plain| over all output words."""
    from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
    from gps_sdr_sim_tpu.ops.plan import plan_epochs
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.testing import (
        NAV, SCENARIOS, TOKYO, random_wire)

    worst, cases = 0, 0
    before = synth.launch_counts["synth_wire"]

    def compare(wire, ca, n_chan, n_out, fmt, label):
        nonlocal worst, cases
        got = synth.synth_wire(wire, ca, n_chan, n_out, fmt)
        want = synth.synth_wire_ref(wire, ca, n_chan, n_out, fmt)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        cases += 1
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version: {label}, "
                                 f"max |diff| {err}")

    configs = [(f"static {r / 1e6:g} Msps", r, dict(static_xyz=TOKYO))
               for r in RATES]
    for name in ("highalt16", "staticfix16"):
        kw = {k: v for k, v in SCENARIOS[name].items() if k != "data_format"}
        configs.append((name, 1.0e6, kw))
    for label, rate, kw in configs:
        scn = build_scenario(ScenarioConfig(
            nav_file=str(NAV), duration=0.5, samp_freq=rate, **kw))
        seg = scn.segments[0]
        staged = synth.stage_epochs(
            plan_epochs(seg, 0, min(seg.n_epochs, scn.n_output_epochs),
                        scn.delt), dev)
        for fmt in FORMATS:
            compare(*staged, scn.iq_buff_size, fmt, f"{label} fmt {fmt}")
    for seed in range(8):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        w = torch.from_numpy(wire).to(dev)
        c = torch.from_numpy(ca).to(dev)
        for fmt in FORMATS:
            compare(w, c, n_chan, 5000, fmt, f"random seed {seed} fmt {fmt}")
    launched = synth.launch_counts["synth_wire"] - before
    if launched != cases:
        raise AssertionError(f"{cases} kernel calls, {launched} launches")
    say(f"phase 3 kernel vs plain: {cases} cases equal "
        f"(6 configs x 3 formats + 8 random wires x 3 formats), "
        f"max |diff| {worst}, launches {launched}")
    return worst


def phase_goldens(dev) -> None:
    from gps_sdr_sim_tpu_torch.testing import (
        SCENARIOS, check, load_goldens, synthesize)

    goldens = load_goldens()
    for name in sorted(SCENARIOS):
        check(synthesize(name, impl="cuda", device=dev), goldens[name],
              SCENARIOS[name]["data_format"])
    say(f"phase 4 goldens: {len(SCENARIOS)}/{len(SCENARIOS)} pass "
        f"through run_simulation(impl='cuda')")


def phase_cli() -> None:
    import numpy as np

    from gps_sdr_sim_tpu_torch.testing import NAV, check, load_goldens

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "cli.bin"
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gps_sdr_sim_tpu_torch.cli", "-e",
             str(NAV), "-l", "35.681298,139.766247,10.0", "-d", "0.3",
             "-s", "1000000", "-o", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        check(np.fromfile(out, np.uint8), load_goldens()["static16"], 16)
        say(f"phase 5 cli: exit 0 in {time.perf_counter() - t:.2f} s, "
            f"{out.stat().st_size} bytes pass golden static16")


class ChecksumSink:
    """A file-like sink that checksums what the runner writes."""

    def __init__(self, fmt: int):
        self.fmt = fmt
        self.sum = 0
        self.nonzero = 0
        self.bytes = 0

    def write(self, data) -> int:
        from gps_sdr_sim_tpu_torch.ops.quantize import checksum_bytes

        s, nz = checksum_bytes(data, self.fmt)
        self.sum += s
        self.nonzero += nz
        n = memoryview(data).nbytes
        self.bytes += n
        return n


class NullSink:
    """The reference's timing run writes to /dev/null."""

    bytes = 0

    def write(self, data) -> int:
        n = memoryview(data).nbytes
        self.bytes += n
        return n


def canonical_scenario(fmt: int, duration: float = 300.0):
    from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario

    return build_scenario(ScenarioConfig(
        nav_file=str(ROOT / "data" / "brdc3540.14n"),
        motion_file=str(ROOT / "data" / "circle.csv"), duration=duration,
        samp_freq=2.6e6, data_format=fmt))


def golden_checksums() -> dict:
    path = ROOT / "tests" / "golden" / "bench_checksum.txt"
    rows = [ln.split() for ln in path.read_text().splitlines() if ln.strip()]
    return {int(r[0]): (int(r[1]), int(r[2])) for r in rows}


def phase_canonical(torch, dev) -> tuple[int, dict]:
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.quantize import wrap_int32
    from gps_sdr_sim_tpu_torch.runner import run_simulation

    goldens = golden_checksums()
    scns = {fmt: canonical_scenario(fmt) for fmt in FORMATS}
    quiet = lambda s: None  # noqa: E731
    # Warm-up outside the counted run: pinned buffers, caches.
    run_simulation(canonical_scenario(16, 1.0), NullSink(), batch_epochs=100,
                   log=quiet, impl="cuda", device=dev)
    torch.cuda.synchronize()

    synth.launch_counts["synth_wire"] = 0
    sinks, stats = {}, {}
    for fmt in FORMATS:
        sinks[fmt] = ChecksumSink(fmt)
        stats[fmt] = run_simulation(scns[fmt], sinks[fmt], batch_epochs=100,
                                    log=quiet, impl="cuda", device=dev)
    launches = synth.launch_counts["synth_wire"]

    rt = {}
    for fmt in FORMATS:
        scn, sink, st = scns[fmt], sinks[fmt], stats[fmt]
        got = (wrap_int32(sink.sum), sink.nonzero)
        if got != goldens[fmt]:
            raise AssertionError(f"SC{fmt:02d} checksum {got} != golden "
                                 f"{goldens[fmt]}")
        timed = []
        for _ in range(3):
            t = time.perf_counter()
            st_null = run_simulation(scn, NullSink(), batch_epochs=100,
                                     log=quiet, impl="cuda", device=dev)
            timed.append((time.perf_counter() - t, st_null))
        wall, st_null = sorted(timed, key=lambda x: x[0])[1]  # median
        rt[fmt] = scn.total_samples / scn.samp_freq / wall
        say(f"phase 6 canonical SC{fmt:02d}: checksum (sum mod 2^32, "
            f"nonzero) = {got} equals golden; {scn.n_output_epochs} epochs, "
            f"{scn.total_samples} samples, {sink.bytes} bytes; "
            f"checksum pass {json.dumps(st.summary(scn.samp_freq))}; "
            f"null-sink passes wall "
            f"{'/'.join(f'{w:.3f}' for w, _ in timed)} s, median "
            f"{scn.total_samples / wall / 1e6:.1f} Msamples/s = "
            f"{rt[fmt]:.1f}x real time "
            f"{json.dumps(st_null.summary(scn.samp_freq))}")
    return launches, rt


def _time_cuda(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(torch, dev) -> dict:
    from gps_sdr_sim_tpu.ops.plan import plan_epochs
    from gps_sdr_sim_tpu_torch.ops import synth

    scn = canonical_scenario(16)
    seg = scn.segments[0]
    staged = synth.stage_epochs(plan_epochs(seg, 0, 100, scn.delt), dev)
    n = scn.iq_buff_size
    times = {}
    for fmt in FORMATS:
        got = synth.synth_staged_packed(staged, n, fmt)
        want = synth.synth_staged_packed(staged, n, fmt, plain=True)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version on the 100-epoch "
                                 f"batch, fmt {fmt}")
        del got, want
        # Alternate kernel / plain / plain / kernel within one call.
        k1 = _time_cuda(torch, lambda: synth.synth_staged_packed(
            staged, n, fmt), 20)
        p1 = _time_cuda(torch, lambda: synth.synth_staged_packed(
            staged, n, fmt, plain=True), 3)
        p2 = _time_cuda(torch, lambda: synth.synth_staged_packed(
            staged, n, fmt, plain=True), 3)
        k2 = _time_cuda(torch, lambda: synth.synth_staged_packed(
            staged, n, fmt), 20)
        times[fmt] = (min(k1, k2), min(p1, p2))
        samples = 100 * n
        say(f"phase 7 timing SC{fmt:02d}: 100 epochs x {n} samples x "
            f"{staged.n_chan} channels: kernel {k1:.3f}/{k2:.3f} ms "
            f"({samples / min(k1, k2) / 1e6:.3f} Gsamples/s), plain "
            f"{p1:.3f}/{p2:.3f} ms, kernel = plain bit for bit")
    return times


def main() -> int:
    if not (ROOT / KERNEL_SOURCE).is_file():
        print(f"FAIL: {KERNEL_SOURCE} not found beside chip_smoke.py; run "
              f"it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_env(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    max_err = phase_kernel_vs_plain(torch, dev)
    phase_goldens(dev)
    phase_cli()
    launches, rt = phase_canonical(torch, dev)
    if launches == 0:
        raise AssertionError("the canonical run launched no kernel")
    times = phase_timing(torch, dev)
    say(f"summary: real-time factor " + ", ".join(
        f"SC{f:02d} {rt[f]:.1f}x" for f in FORMATS) + f" on {card}")
    say(card)
    say(json.dumps({"kernels": [{
        "name": "synth_wire", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": times[16][0],
        "plain_ms": times[16][1],
        "ms_by_format": {str(f): times[f][0] for f in FORMATS},
        "plain_ms_by_format": {str(f): times[f][1] for f in FORMATS}}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
