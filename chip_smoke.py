#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gps_sdr_sim_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

An import hook installed first makes any import of jax, of the JAX
package (gps_sdr_sim_tpu) or of the repository's root tools and
__graft_entry__ raise, here and in the CLI processes it starts, so the run
shows that the port stands alone. Phases, each printing one line
of findings (any failure raises and exits non-zero):

 1. environment: card name and power limit, CUDA, nvcc, triton;
 2. build csrc/synth.cu, csrc/vpu_peak.cu and csrc/synth_profile.cu with
    nvcc for sm_90a, the three nvcc processes side by side (timed as
    set-up); print each synthesis
    instantiation's registers, shared memory and spills (-Xptxas -v) and
    its SASS instructions per (sample, channel) (its channel loop's length
    over the samples one trip covers, a diagnostic: the bounds count the
    algorithm's operations), and each vpu_peak case's instructions per
    round;
 3. the synthesis kernel's three modes (packed words, int16 planes, raw
    int32 sums), with the nav window walk and with the nav mask table,
    against their plain PyTorch versions on the card, word for word: four
    sample rates, the highalt16 and staticfix16 configurations, and seeded
    random wires (two with code steps just below the kernel's domain edge of
    2 chips per sample); the planes, interleaved, must be the SC16 words; on
    the
    six real configurations the mask table's words equal the walk's;
 4. the 11 C-reference IQ goldens through run_simulation(impl="cuda");
 5. the CLI end to end as a subprocess, checked against golden static16;
 6. the canonical workload (circle.csv, 300 s, 2.6 Msps, SC16/SC08/SC01)
    through run_simulation(impl="cuda"): (sum, nonzero) must equal
    tests/golden/bench_checksum.txt exactly; the median of three passes
    into a null sink gives the real-time factor;
 6b. the same with GPS_SDR_SIM_NAV_GATHER=1 (the mask-table kernel) through
    impl="cuda" (three formats) and impl="cuda-sharded" on the 1x1 and 2x2
    meshes (SC16): the same checksums, and the real-time factors beside
    the walk's;
 7. kernel and plain-version times of each mode, walk and mask table, on
    one 100-epoch 2.6 Msps batch, beside each mode's bound (the
    algorithm's operations, tools/card.ALGORITHM_OPS); the two
    variants of each mode are timed in turns by the A/B harness
    (tools/ab_kernel.compare), which gives b_over_a;
 8. the canonical workload through run_simulation(impl="cuda-sharded") on a
    1x1 mesh (planes mode) and on a 2x2 mesh with every entry on this card
    (raw mode and the chan reduction): the same checksums; a null-sink
    median of three for SC16;
 9. shard files: 30 s of the canonical scenario as 4 shards, concatenated,
    equal the single-file run; a truncated shard is restored by resume;
    two CLI processes joined by --multihost write the same bytes;
 10. the int32 microbenchmark (tools/vpu_peak): kernel = plain version in
    every timed run at its shape, the fold check, and the measured peak in
    source ops/s and SASS instructions/s beside the published rate the
    bounds use;
 11. --profile: one short run of the CLI's main() in this process writes a
    torch.profiler trace that parses and holds synth_wire_kernel events;
    the summed kernel time over the traced window is the kernels' busy
    share of that window;
 12. the receiver closure (gps_sdr_sim_tpu_torch.receiver) on the card: a
    26 s static base capture (Tokyo, 2.048 Msps, SC16) synthesized by the
    CUDA kernel, byte-equal to the plain version's capture on the card,
    goes through the receiver CLI's main() with --track 26 --pvt
    --rinex-obs --rinex-nav: the acquired PRNs must be the scenario's
    visible set, every channel must decode a parity-valid subframe, and the
    fix must lie within 10 m (max residual below 5 m); a rover capture ~32 m
    away (26 s, also byte-equal to the plain version's) is tracked on the
    card and solved against the base's RINEX pair as a double-difference
    baseline that must FIX (ratio above 3) within 5 mm, DD phase rms below
    5 mm; on the first 2 s of the base the search, acquisition and tracking
    on the card agree with the same functions on the CPU within the CPU
    tests' tolerances. Prints acquisition, tracking, decode/PVT and RTK
    times. Then the int8 circulant search (receiver.acquire_mxu, its
    products through torch._int_mm on the int8 tensor cores): on the base
    capture it detects the 13 PRNs acquire() detects on the card, at the
    same code phases and Doppler within 20 Hz, and on the first 2 s it
    agrees with its CPU run within SEARCH_RTOL; prints its search time
    beside the FFT search's, its products' time beside their bound at the
    published 1,979 int8 TOPS, and acquire_mxu()'s wall beside acquire()'s;
 13. the DeviceBatch path: (a) the canonical workload planned by plan_batch
    in 100-epoch batches through ops.synth.synth_batch (the row kernel,
    planes) and parallel.synth_rows_sharded on a 2x2 mesh of this card (raw
    mode and the chan reduction), every batch equal to the row kernel's
    plain version on the card; packed, the batches give the golden
    SC16/SC08/SC01 checksums (the 2x2 mesh's SC16); (b) run_simulation with
    impl="closed" (three formats, real-time factor of SC16) and
    "closed-sharded" on the 2x2 mesh (SC16) give them too, with
    plan_seconds beside the wire path's; (c) the multi-chip dry run
    (gps_sdr_sim_tpu_torch.entry.dryrun_multichip) on a mesh of four
    entries of this card: closed-sharded 2x2 = closed, row-sharded 4x1 and
    2x2 = closed, wire-sharded 2x2 = wire, wire = closed; (d) each row
    mode's kernel and plain-version time on one 100-epoch batch beside its
    bound; (e) the tools/bench_scaling sweep of the three impls over meshes
    of 1, 2 and 4 entries of this card;
 14. the full 86,400 s day (static Tokyo, 2.6 Msps, SC16, 300-epoch
    batches) through the day-run tool's synth phase
    (gps_sdr_sim_tpu_torch.tools.dayrun.synth_day: the streaming planner on
    a producer thread, the packed kernel and an on-card checksum per batch,
    the sampled blocks read back on a collector thread): the wrapped
    checksum, the least nonzero count of a batch and the sha256 of all 33
    sampled blocks must equal those recorded in DAYRUN_r05.json (the run
    whose blocks were held to the C reference); every batch that holds a
    sampled block is synthesized again by the plain version on the card,
    whose words must equal the kernel's and whose blocks must give the same
    sha256. Prints wall, plan_s, the real-time factor, the throughput
    timeline's min/median/max and the kernel's busy share (kernel time by
    CUDA events over wall).
 15. the benchmark (gps_sdr_sim_tpu_torch.tools.bench) as a subprocess, as
    a user runs it, for --impl cuda, cuda-sharded and closed, one session
    each at the canonical size: each must exit 0 and print one JSON line
    with checksum_verified true in every format (held exactly to
    tests/golden/bench_checksum.txt), phase 1's card line, and launches of
    the impl's kernel (none for closed). Prints each line and the phase's
    wall.
 16. kernel cost attribution: each ablated instantiation of the packed
    kernel (csrc/synth_profile.cu: no_trig_gather, no_ca_gather,
    no_nav_walk, no_gathers in SC16/SC08/SC01) with its SASS per (sample,
    channel), registers and spills, and each held to its plain version
    (ops.synth.schedule_words) on the canonical 100-epoch batch, word for
    word; then tools/profile_kernel (400 epochs) and tools/op_budget
    --profile, each as a subprocess through the import hook, whose summary
    lines it prints; then a 2 s SC08 capture from the CLI's -o - piped
    through tools/uhd_player --sink, whose fc32 stream must equal a NumPy
    decode of the capture. The ablated kernels are not kernels of the JAX
    package's table, so the kernel report does not list them.
 17. the randomized CLI matrix (gps_sdr_sim_tpu_torch.tools.fuzz_oracle):
    the first 16 cases of seed 0, all of FORCED (eight short crossings of
    the fixed-point carrier with NMEA, rocket, satellite, -t and -T; eight
    31-95 s runs across the 30 s nav and re-allocation boundaries), each
    through fuzz_oracle.run_case, four at a time: the CLI with --impl cuda
    against the CLI with --impl torch on the same card standing in for the
    C oracle (with --carrier-phase fixed where the case's carrier is
    fixed). Every case must pass compare_case with equal bytes (mismatch
    fraction 0, max delta 0) and equal canonical stderr; the stand-in must
    launch no kernel. Prints each case's argv, samples and both walls.
 18. the RTK closures (gps_sdr_sim_tpu_torch.tools.rtk_oracle) as a
    subprocess, at the tool's own size, with the CLI (--impl cuda) behind
    an executable wrapper as its --oracle: four 26 s SC16 captures at 2.048
    Msps from the CUDA kernel, acquired and tracked on the card. The
    static closure must fix within 10 mm and the kinematic closure (a
    rover on circle.csv, the base at its centroid) must fix with every
    epoch within 50 mm of the trajectory; each capture, made again by the
    plain version on the card, must have the same sha256. Prints the
    report's numbers beside RTK_ORACLE_r02.json's (the C reference's
    captures) and the phase's wall.

The line before the last is the kernel report (each synthesis row with its
design, DESIGN); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# Installed before anything of the port is imported; given to every CLI
# process this script starts.
IMPORT_HOOK = """
import importlib.abc, sys
class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "gps_sdr_sim_tpu", "tools",
                                  "__graft_entry__", "bench",
                                  "bench_scaling", "deepcheck", "dayrun"):
            raise ImportError(f"the port imported {name}")
sys.meta_path.insert(0, _NoJax())
"""

def tool(module: str) -> str:
    """The -c program that runs `module` as __main__ under IMPORT_HOOK."""
    return IMPORT_HOOK + (f"import runpy; runpy.run_module("
                          f"'gps_sdr_sim_tpu_torch.{module}', "
                          f"run_name='__main__')")


def counted(module: str, log: pathlib.Path, extra=(),
            hash_output: bool = False) -> str:
    """A program like tool(module)'s, with `extra` appended to its
    arguments, that then appends one JSON line to `log`: its arguments
    (without `extra`), the kernels' launch counts of its run and, with
    `hash_output`, the sha256 of the file its -o names."""
    return IMPORT_HOOK + (
        f"import hashlib, json, runpy, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"argv = sys.argv[1:]\n"
        f"sys.argv += {list(extra)!r}\n"
        f"from gps_sdr_sim_tpu_torch.ops import synth\n"
        f"try:\n"
        f"    runpy.run_module('gps_sdr_sim_tpu_torch.{module}', "
        f"run_name='__main__')\n"
        f"finally:\n"
        f"    entry = {{'argv': argv, 'launches': synth.launch_counts}}\n"
        f"    if {hash_output!r}:\n"
        f"        with open(argv[argv.index('-o') + 1], 'rb') as f:\n"
        f"            entry['sha256'] = hashlib.file_digest(\n"
        f"                f, 'sha256').hexdigest()\n"
        f"    with open({str(log)!r}, 'a') as f:\n"
        f"        f.write(json.dumps(entry) + '\\n')\n")


CLI = tool("cli")
BENCH = tool("tools.bench")
# The kernel each bench impl must launch (None: no kernel).
BENCH_IMPLS = {"cuda": "synth_wire", "cuda-sharded": "synth_wire_planes",
               "closed": None}

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCE = "gps_sdr_sim_tpu_torch/csrc/synth.cu"
VPU_PEAK_SOURCE = "gps_sdr_sim_tpu_torch/csrc/vpu_peak.cu"
# Each synthesis mode's wrapper (the launch-count key) and the Pallas code
# it replaces; the _nav keys count the mask-table variant of each mode.
KERNELS = {
    "synth_wire": "gps_sdr_sim_tpu/ops/synth_pallas.py:171",
    "synth_wire_planes": "gps_sdr_sim_tpu/ops/synth_pallas.py:497",
    "synth_wire_raw": "gps_sdr_sim_tpu/ops/synth_pallas.py:500",
    "synth_wire_nav": "gps_sdr_sim_tpu/ops/synth_pallas.py:377",
    "synth_wire_planes_nav": "gps_sdr_sim_tpu/ops/synth_pallas.py:565",
    "synth_wire_raw_nav": "gps_sdr_sim_tpu/ops/synth_pallas.py:565",
}
# The row form's wrappers; both replace the row-parameter form of K1
# (_get_pallas_fn with uniform=False; quantize=False for the raw mode).
ROW_KERNELS = {
    "synth_rows_planes": "gps_sdr_sim_tpu/ops/synth_pallas.py:508",
    "synth_rows_raw": "gps_sdr_sim_tpu/ops/synth_pallas.py:508",
}
VPU_PEAK_REPLACES = "tools/vpu_peak.py:58"
# The synthesis kernels' design: every mode runs one sample loop of
# csrc/synth.cu.
DESIGN = "channels outer, stepped phases, per-chip sign words"
NAV_SWITCH = "GPS_SDR_SIM_NAV_GATHER"
RATES = (1.0e6, 1310720.0, 1331200.0, 2.6e6)
# Phase 17's cases in flight at once, each one CLI process at a time.
FUZZ_WORKERS = 4
FORMATS = (16, 8, 1)


def say(line: str) -> None:
    print(line, flush=True)


def phase_env(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False")
    from gps_sdr_sim_tpu_torch.ops.synth_cuda import nvcc_path
    from gps_sdr_sim_tpu_torch.tools.card import card_line

    card = card_line()
    say(card)

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


def phase_build() -> dict:
    """Builds the three sources side by side (the profile library is
    phase 16's); prints each synthesis
    instantiation's -Xptxas -v usage and SASS instructions per (sample,
    channel); returns each vpu_peak case's SASS instructions per round,
    under vpu_peak/ keys."""
    from gps_sdr_sim_tpu_torch.ops import synth_cuda
    from gps_sdr_sim_tpu_torch.tools import vpu_peak

    t = time.perf_counter()
    sources = (synth_cuda.SOURCE, synth_cuda.VPU_PEAK_SOURCE,
               synth_cuda.PROFILE_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(synth_cuda.build, sources))
    synth_cuda.load()
    built = time.perf_counter() - t
    per_sample = synth_cuda.channel_loop_instructions(synth_cuda.sass_loops(
        synth_cuda.sass(libs[0])))
    usage = {synth_cuda.instantiation_key(fn): u for fn, u in
             synth_cuda.ptxas_usage(synth_cuda.build_log(libs[0])).items()
             if synth_cuda.instantiation_key(fn)}
    if sorted(usage) != sorted(per_sample):
        raise AssertionError(f"-Xptxas -v reports kernels {sorted(usage)}")
    rounds = vpu_peak.round_instructions(synth_cuda.sass_loops(
        synth_cuda.sass(libs[1])))
    say(f"phase 2 build: {', '.join(lib.name for lib in libs)} in "
        f"{built:.2f} s ({len(libs)} nvcc side by side)")
    for key, n in per_sample.items():
        u = usage[key]
        say(f"phase 2 {key}: {n:.2f} SASS instructions per (sample, channel) "
            f"({n * synth_cuda.SAMPLES_PER_TRIP:.0f} per trip of the channel "
            f"loop over {synth_cuda.SAMPLES_PER_TRIP} samples); -Xptxas -v: "
            f"{u['registers']} registers, {u['smem_bytes']} bytes smem, "
            f"spill stores {u['spill_stores']} / loads {u['spill_loads']} "
            f"bytes")
    say(f"phase 2 vpu_peak SASS instructions per round: "
        f"{json.dumps(rounds)}")
    return {f"vpu_peak/{k}": v for k, v in rounds.items()}


def phase_kernel_vs_plain(torch, dev) -> dict:
    """Returns each kernel's largest |kernel - plain| over all outputs."""
    import numpy as np

    from gps_sdr_sim_tpu_torch.models.scenario import (
        ScenarioConfig,
        build_scenario,
    )
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
    from gps_sdr_sim_tpu_torch.testing import (
        NAV, SCENARIOS, TOKYO, random_wire)

    worst = dict.fromkeys(KERNELS, 0)
    calls = dict.fromkeys(KERNELS, 0)
    before = {k: synth.launch_counts[k] for k in KERNELS}

    def check(name, got, want, label):
        for g, w in zip(got, want):
            err = int((g.long() - w.long()).abs().max())
            worst[name] = max(worst[name], err)
            if not torch.equal(g, w):
                raise AssertionError(f"{name} != plain version: {label}, "
                                     f"max |diff| {err}")
        calls[name] += 1

    def compare(wire, ca, n_chan, n_out, label, nav):
        """Every mode of one variant against its plain version; returns
        the outputs (SC16/SC08/SC01 words, planes, raw)."""
        sfx = "_nav" if nav else ""
        outs = []
        for fmt in FORMATS:
            got = synth.synth_wire(wire, ca, n_chan, n_out, fmt, nav)
            check(f"synth_wire{sfx}", [got], [synth.synth_wire_ref(
                wire, ca, n_chan, n_out, fmt, nav)], f"{label} fmt {fmt}")
            outs.append((got,))
        planes = synth.synth_wire_planes(wire, ca, n_chan, n_out, nav)
        check(f"synth_wire_planes{sfx}", planes, synth.synth_wire_planes_ref(
            wire, ca, n_chan, n_out, nav), label)
        raw = synth.synth_wire_raw(wire, ca, n_chan, n_out, nav)
        check(f"synth_wire_raw{sfx}", raw,
              synth.synth_wire_raw_ref(wire, ca, n_chan, n_out, nav), label)
        torch.cuda.synchronize()
        if not torch.equal(torch.stack(planes, dim=-1).reshape(
                wire.shape[0], -1), outs[0][0].view(torch.int16)):
            raise AssertionError(f"planes interleaved != SC16 words: {label}")
        return outs + [planes, raw]

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
        walk = compare(*staged, scn.iq_buff_size, label, nav=False)
        gather = compare(*staged, scn.iq_buff_size, label, nav=True)
        for w, g in zip(walk, gather):
            if not all(torch.equal(a, b) for a, b in zip(w, g)):
                raise AssertionError(f"mask table != window walk on the "
                                     f"real plan {label}")
    for seed in range(10):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        if seed >= 8:  # code steps just inside the kernel's domain
            wire[..., 2:4] = np.full(wire.shape[:2], synth.MAX_CODE_STEP - 1,
                                     np.int64).view(np.int32).reshape(
                                         *wire.shape[:2], 2)
        wire, ca = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
        for nav in (False, True):
            compare(wire, ca, n_chan, 5000, f"random seed {seed}", nav)
    for k in KERNELS:
        launched = synth.launch_counts[k] - before[k]
        if launched != calls[k]:
            raise AssertionError(f"{k}: {calls[k]} calls, {launched} "
                                 f"launches")
    say(f"phase 3 kernel vs plain: equal in every case (6 configs + 10 "
        f"random wires, 2 of them at code steps just below 2 chips per "
        f"sample; packed x 3 formats, planes, raw; window walk and mask "
        f"table): cases {json.dumps(calls)}, max |diff| "
        f"{json.dumps(worst)}; planes interleaved = SC16 words in all 32; "
        f"mask-table words = walk words on the 6 real configs")
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
            [sys.executable, "-c", CLI, "-e", str(NAV), "-l",
             "35.681298,139.766247,10.0", "-d", "0.3", "-s", "1000000",
             "-o", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        check(np.fromfile(out, np.uint8), load_goldens()["static16"], 16)
        say(f"phase 5 cli: exit 0 in {time.perf_counter() - t:.2f} s, "
            f"{out.stat().st_size} bytes pass golden static16")


def canonical_runs(torch, scns: dict, label: str, timed_formats,
                   formats=FORMATS, on_mismatch=None,
                   **run_kw) -> tuple[dict, dict, dict]:
    """The canonical workload in `formats` through run_simulation(
    **run_kw), with every launch count set to 0 just before and read just
    after; then null-sink passes of `timed_formats`. Returns (launch
    counts, real-time factor by timed format, RunStats of the checksum
    pass by format). A checksum that differs from the golden raises, after
    on_mismatch(fmt) where given."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.quantize import wrap_int32
    from gps_sdr_sim_tpu_torch.runner import run_simulation
    from gps_sdr_sim_tpu_torch.tools.bench import (
        ChecksumSink,
        NullSink,
        canonical_scenario,
        golden_checksums,
    )

    goldens = golden_checksums()
    quiet = lambda s: None  # noqa: E731
    # Warm-up outside the counted run: pinned buffers, caches.
    run_simulation(canonical_scenario(16, 1.0), NullSink(), batch_epochs=100,
                   log=quiet, **run_kw)
    torch.cuda.synchronize()

    for k in synth.launch_counts:
        synth.launch_counts[k] = 0
    sinks, stats = {}, {}
    for fmt in formats:
        sinks[fmt] = ChecksumSink(fmt)
        stats[fmt] = run_simulation(scns[fmt], sinks[fmt], batch_epochs=100,
                                    log=quiet, **run_kw)
    launches = dict(synth.launch_counts)

    rt = {}
    for fmt in formats:
        scn, sink, st = scns[fmt], sinks[fmt], stats[fmt]
        got = (wrap_int32(sink.sum), sink.nonzero)
        if got != goldens[fmt]:
            if on_mismatch is not None:
                on_mismatch(fmt)
            raise AssertionError(f"{label} SC{fmt:02d} checksum {got} != "
                                 f"golden {goldens[fmt]}")
        line = (f"{label} SC{fmt:02d}: checksum (sum mod 2^32, nonzero) = "
                f"{got} equals golden; {scn.n_output_epochs} epochs, "
                f"{scn.total_samples} samples, {sink.bytes} bytes; checksum "
                f"pass {json.dumps(st.summary(scn.samp_freq))}")
        if fmt in timed_formats:
            timed = []
            for _ in range(3):
                t = time.perf_counter()
                st_null = run_simulation(scn, NullSink(), batch_epochs=100,
                                         log=quiet, **run_kw)
                timed.append((time.perf_counter() - t, st_null))
            wall, st_null = sorted(timed, key=lambda x: x[0])[1]  # median
            rt[fmt] = scn.total_samples / scn.samp_freq / wall
            line += (f"; null-sink passes wall "
                     f"{'/'.join(f'{w:.3f}' for w, _ in timed)} s, median "
                     f"{scn.total_samples / wall / 1e6:.1f} Msamples/s = "
                     f"{rt[fmt]:.1f}x real time "
                     f"{json.dumps(st_null.summary(scn.samp_freq))}")
        say(line)
    say(f"{label} launches: {json.dumps(launches)}")
    return launches, rt, stats


def share_without_wrap(ops: int, sample_channels: int, ms: float) -> float:
    """The share of `ms` that the operations bound would give at 13
    operations per (sample, channel), the code period wrap left out: a
    diagnostic beside the bound, which counts it."""
    from gps_sdr_sim_tpu_torch.tools.card import ALGORITHM_OPS, ISSUE_PER_S

    ops -= ALGORITHM_OPS["code period wrap"] * sample_channels
    return ops / ISSUE_PER_S * 1e3 / ms


def phase_timing(torch, dev) -> tuple[dict, dict]:
    """Kernel and plain-version ms of every mode, window walk and mask
    table, on one 100-epoch 2.6 Msps batch, at the widths the main path
    gives each: the packed words over the active channels, the planes over
    all 16 wire channels (a 1x1 mesh), the raw sums over one chan shard of
    8 (a 2x2 mesh). The two variants of a mode are timed in turns by the
    A/B harness (tools/ab_kernel.compare), which first checks that they
    write the same words. Returns ({report key: (ms, plain ms, bound ms,
    bound by)}, {walk key: mask table / window walk})."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
    from gps_sdr_sim_tpu_torch.tools import ab_kernel
    from gps_sdr_sim_tpu_torch.tools.bench import canonical_scenario
    from gps_sdr_sim_tpu_torch.tools.card import (
        bound_ms,
        synth_operations,
        time_ms,
    )

    scn = canonical_scenario(16)
    staged = synth.stage_epochs(
        plan_epochs(scn.segments[0], 0, 100, scn.delt), dev)
    n = scn.iq_buff_size
    wire, ca = staged.wire, staged.ca_words
    half = wire[:, :8].contiguous(), ca[:8].contiguous()
    modes = [(f"synth_wire/{fmt}", wire, ca, staged.n_chan,
              lambda w, c, k, g, f=fmt: synth.synth_wire(w, c, k, n, f, g),
              lambda w, c, k, g, f=fmt: synth.synth_wire_ref(
                  w, c, k, n, f, g)) for fmt in FORMATS]
    modes.append((
        "synth_wire_planes", wire, ca, wire.shape[1],
        lambda w, c, k, g: synth.synth_wire_planes(w, c, k, n, g),
        lambda w, c, k, g: synth.synth_wire_planes_ref(w, c, k, n, g)))
    modes.append((
        "synth_wire_raw", *half, 8,
        lambda w, c, k, g: synth.synth_wire_raw(w, c, k, n, g),
        lambda w, c, k, g: synth.synth_wire_raw_ref(w, c, k, n, g)))
    times, ratios = {}, {}
    for key, w, c, k, kernel, plain in modes:
        ab = ab_kernel.compare(
            {"walk": lambda: kernel(w, c, k, False),
             "mask table": lambda: kernel(w, c, k, True)},
            passes=5, reps=4, device=dev)
        if not ab["bit_equal"]:
            raise AssertionError(f"{key}: mask table != window walk on the "
                                 f"100-epoch batch")
        ratios[key] = ab["b_over_a"]
        # The data needs the (epoch, channel) pairs whose gain is not 0.
        pairs = int((w[:, :k, 11] != 0).sum())
        in_bytes = w.numel() * 4 + c.numel() * 4 + 2 * 512 * 4
        ops = synth_operations(pairs * n, w.shape[0] * n,
                               key != "synth_wire_raw")
        for g, label in ((False, "walk"), (True, "mask table")):
            name = nav_key(key) if g else key
            got, want = kernel(w, c, k, g), plain(w, c, k, g)
            got, want = (got,) if torch.is_tensor(got) else got, \
                (want,) if torch.is_tensor(want) else want
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} != plain version on the "
                                     f"100-epoch batch")
            out_bytes = sum(a.numel() * a.element_size() for a in got)
            del got, want
            ms = ab["best_s"][label] * 1e3
            plain_ms = time_ms(lambda: plain(w, c, k, g), 2, dev, warm=False)
            bound, by = bound_ms(in_bytes, out_bytes, ops)
            times[name] = (ms, plain_ms, bound, by)
            say(f"phase 7 timing {name}: {w.shape[0]} epochs x {n} samples "
                f"x {k} channels ({pairs} (epoch, channel) pairs with gain): "
                f"kernel {ms:.4f} ms "
                f"({w.shape[0] * n / ms / 1e6:.3f} Gsamples/s; the A/B's "
                f"reps {'/'.join(f'{t * 1e3:.4f}' for t in ab['reps_s'][label])}"
                f" ms), plain {plain_ms:.3f} ms, "
                f"bound {bound:.4f} ms by {by} ({ops} operations, "
                f"{out_bytes} bytes out; {bound / ms:.1%} of it; "
                f"{share_without_wrap(ops, pairs * n, ms):.1%} at 13 "
                f"operations per pair), kernel = plain bit for bit")
    say("phase 7 A/B (tools/ab_kernel.compare, 4 reps x 5 passes, walk and "
        "mask table bit-equal), b_over_a = mask table / window walk: "
        + ", ".join(f"{k} {r:.4f}" for k, r in ratios.items()))
    return times, ratios


def phase_shard_files(torch, dev, duration: float = 30.0) -> None:
    """Shard files, concat, resume and --multihost against the single-file
    stream of the same scenario (SC16)."""
    from gps_sdr_sim_tpu_torch.parallel import (
        concat_shards,
        make_mesh,
        run_simulation_sharded,
    )
    from gps_sdr_sim_tpu_torch.runner import run_simulation
    from gps_sdr_sim_tpu_torch.tools.bench import canonical_scenario

    def digest(path) -> str:
        return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()

    scn = canonical_scenario(16, duration)
    single = io.BytesIO()
    run_simulation(scn, single, batch_epochs=100, log=lambda s: None,
                   impl="cuda", device=dev)
    want = hashlib.sha256(single.getvalue()).hexdigest()
    size = len(single.getvalue())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        shard_dir = tmp / "shards"

        def shards(resume: bool):
            run_simulation_sharded(
                scn, str(shard_dir), n_shards=4, batch_epochs=100,
                impl="cuda-sharded", resume=resume, device=dev,
                mesh=make_mesh(1, 1, [dev]))
            concat_shards(str(shard_dir), str(tmp / "joined.bin"))
            if digest(tmp / "joined.bin") != want:
                raise AssertionError(f"shards (resume={resume}) != single "
                                     f"file")

        shards(resume=False)
        victim = shard_dir / "shard_00002.bin"
        victim.write_bytes(victim.read_bytes()[:victim.stat().st_size // 2])
        kept = (shard_dir / "shard_00000.bin").stat().st_mtime_ns
        shards(resume=True)
        if (shard_dir / "shard_00000.bin").stat().st_mtime_ns != kept:
            raise AssertionError("resume rewrote a complete shard")

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", CLI, "-e", str(ROOT / "data" /
             "brdc3540.14n"), "-u", str(ROOT / "data" / "circle.csv"),
             "-d", f"{duration:g}", "-s", "2600000", "--device", str(dev),
             "--shard-dir", str(tmp / "mh"), "--shards", "4", "--concat",
             "--multihost", f"127.0.0.1:{port},{rank},2",
             "-o", str(tmp / "mh.bin")],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(2)]
        try:
            for rank, proc in enumerate(procs):
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"--multihost rank {rank} exited "
                                         f"{proc.returncode}:\n{err[-4000:]}")
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        if digest(tmp / "mh.bin") != want:
            raise AssertionError("--multihost output != single file")
        say(f"phase 9 shard files: {duration:g} s SC16, {size} bytes: 4 "
            f"shards concatenated = single file; a truncated shard restored "
            f"by resume (complete shards untouched); two --multihost "
            f"processes on {dev} with --concat = single file "
            f"({time.perf_counter() - t:.2f} s)")


def nav_key(key: str) -> str:
    """The mask-table variant's key of a walk key (synth_wire/16 ->
    synth_wire_nav/16, synth_wire_raw -> synth_wire_raw_nav)."""
    base, sep, fmt = key.partition("/")
    return f"{base}_nav{sep}{fmt}"


def locate_nav_difference(torch, scn, dev) -> None:
    """Where the mask-table kernel's stream leaves the window walk's: the
    first differing epoch and byte offset of the file, and whether the mask
    table's plain version writes the kernel's words there."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
    from gps_sdr_sim_tpu_torch.ops.quantize import words_to_bytes

    fmt, n = scn.config.data_format, scn.iq_buff_size
    per_epoch = synth.packed_bytes(n, fmt)
    for seg in scn.segments:
        for e in range(0, seg.n_epochs, 100):
            st = synth.stage_epochs(plan_epochs(
                seg, e, min(e + 100, seg.n_epochs), scn.delt), dev)
            walk, gather = (synth.synth_wire(*st, n, fmt, g)
                            for g in (False, True))
            a, b = (words_to_bytes(x.cpu().numpy(), n, fmt).reshape(-1)
                    for x in (walk, gather))
            if (a != b).any():
                i = int((a != b).nonzero()[0][0])
                plain = synth.synth_wire_ref(*st, n, fmt, True)
                epoch = seg.first_epoch - 1 + e + i // per_epoch
                same = bool(torch.equal(plain, gather))
                say(f"phase 6b SC{fmt:02d}: mask table != window walk from "
                    f"output epoch {epoch}, file byte "
                    f"{(epoch * per_epoch) + i % per_epoch}; mask-table plain "
                    f"version = kernel there: {same}")
                return
    say(f"phase 6b SC{fmt:02d}: no differing epoch found")


def phase_nav_canonical(torch, scns: dict, dev, meshes) -> tuple:
    """Phase 6b: the canonical workload with the nav switch on, through the
    packed path (3 formats) and the sharded path on each mesh (SC16).
    Returns (packed launches, packed RT by format, {mesh: (launches,
    RT)})."""
    def locate(fmt):
        locate_nav_difference(torch, scns[fmt], dev)

    os.environ[NAV_SWITCH] = "1"
    try:
        launches, rt, _ = canonical_runs(
            torch, scns, "phase 6b canonical, mask table", (16,),
            on_mismatch=locate, impl="cuda", device=dev)
        sharded = {label: canonical_runs(
            torch, scns, f"phase 6b cuda-sharded {label}, mask table", (16,),
            formats=(16,), on_mismatch=locate, impl="cuda-sharded",
            mesh=mesh) for label, mesh in meshes}
    finally:
        del os.environ[NAV_SWITCH]
    for got, walk_key in ((launches, "synth_wire"),
                          (sharded["1x1"][0], "synth_wire_planes"),
                          (sharded["2x2"][0], "synth_wire_raw")):
        if got[walk_key] != 0 or got[nav_key(walk_key)] == 0:
            raise AssertionError(f"with {NAV_SWITCH}=1 the path launched "
                                 f"{json.dumps(got)}")
    return launches, rt, sharded


def phase_vpu_peak(sass_ops: dict) -> dict:
    """Phase 10: tools/vpu_peak. Returns its kernel report fields."""
    from gps_sdr_sim_tpu_torch.tools import vpu_peak
    from gps_sdr_sim_tpu_torch.tools.card import ISSUE_PER_S, bound_ms

    tiles, rounds = 2048, 512
    vpu_peak.launch_counts["vpu_peak"] = 0
    res = vpu_peak.measure("cuda", tiles=tiles, rounds=rounds, reps=3)
    launches = vpu_peak.launch_counts["vpu_peak"]
    alu = next(c for c in res["cases"] if c["name"] == "alu")
    elems = tiles * vpu_peak.SLAB * vpu_peak.LANES
    in_bytes = (vpu_peak.SLAB + 1) * vpu_peak.LANES * 4
    # A microbenchmark of the issue rate: its instructions are its work, so
    # its operations are its own SASS per round (not an algorithm's count).
    bound, by = bound_ms(in_bytes, elems * 4,
                         sass_ops["vpu_peak/alu"] * elems * rounds)
    for c in res["cases"]:
        say(f"phase 10 vpu_peak {c['name']}: {c['ms']:.4f} ms (plain "
            f"{c['plain_ms']:.3f} ms, equal word for word), "
            f"{c['source_ops_per_s'] / 1e12:.3f} T source ops/s, "
            f"{c['sass_per_s'] / 1e12:.3f} T SASS instructions/s "
            f"({c['sass_per_round']} per round, {c['rounds']} rounds x "
            f"{c['tiles']} tiles)")
    fold = res["fold_check"]
    say(f"phase 10 vpu_peak: kernel = plain version in every run at its "
        f"shape (max |diff| {res['max_abs_err']}); fold check passed (alu "
        f"{fold['alu_ms']:.4f} ms >= 1.5 x alu/4 {fold['alu4_ms']:.4f} ms); "
        f"two-point peak {res['peak_source_ops_per_s'] / 1e12:.3f} T source "
        f"ops/s = {res['peak_sass_per_s'] / 1e12:.3f} T SASS "
        f"instructions/s, published issue rate {ISSUE_PER_S / 1e12:.1f} T/s "
        f"({res['peak_sass_per_s'] / ISSUE_PER_S:.3f} of it); one gather "
        f"~{res['gather_cost_alu_ops']:.2f} alu ops, one imul "
        f"~{res['imul_cost_alu_ops']:.2f}, one f32 round trip "
        f"~{res['f32_roundtrip_cost_alu_ops']:.2f}; alu kernel "
        f"{alu['ms']:.4f} ms, plain {alu['plain_ms']:.3f} ms, bound "
        f"{bound:.4f} ms by {by}; {res['card']}")
    return {"launches": launches, "max_abs_err": res["max_abs_err"],
            "ms": alu["ms"], "plain_ms": alu["plain_ms"], "bound_ms": bound,
            "bound_by": by}


def read_trace(path) -> tuple:
    """(complete events, kernel events, summed kernel us, traced window
    us) of a torch.profiler Chrome trace."""
    events = [e for e in json.loads(pathlib.Path(path).read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    return events, kernels, sum(e["dur"] for e in kernels), window


def phase_profile(dev) -> None:
    """Phase 11: one short run of the CLI's main() with --profile on the
    card, in this process."""
    import contextlib

    from gps_sdr_sim_tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        prof = pathlib.Path(tmp) / "prof"
        err = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main([
                "-e", str(ROOT / "data" / "brdc3540.14n"), "-u",
                str(ROOT / "data" / "circle.csv"), "-d", "30", "-s",
                "2600000", "--batch-epochs", "100", "--device", str(dev),
                "--profile", str(prof), "-o", os.devnull])
        if rc != 0:
            raise AssertionError(f"--profile run exited {rc}:\n"
                                 f"{err.getvalue()[-4000:]}")
        last = err.getvalue().strip().splitlines()[-1]
        if last != f"profiler trace written to {prof}":
            raise AssertionError(f"--profile stderr ends {last!r}")
        traces = list(prof.glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"--profile wrote {traces}")
        events, kernels, busy, window = read_trace(traces[0])
        synth = [e for e in kernels if "synth_wire_kernel" in e["name"]]
        if not synth:
            raise AssertionError(f"the trace holds no synth_wire_kernel "
                                 f"event ({len(kernels)} kernel events)")
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
        say(f"phase 11 --profile: 30 s of the canonical scenario (SC16, "
            f"batches of 100 epochs, {time.perf_counter() - t:.2f} s); trace "
            f"{traces[0].name} parses, {len(events)} events, "
            f"{len(synth)} synth_wire_kernel events "
            f"({sum(e['dur'] for e in synth) / 1e3:.3f} ms), "
            f"{len(kernels)} kernel events ({busy / 1e3:.3f} ms), "
            f"{len(copies)} copies ({sum(e['dur'] for e in copies) / 1e3:.3f} "
            f"ms) in a traced window of {window / 1e3:.3f} ms: kernel busy "
            f"share of the traced window {busy / window:.4f}")


@contextlib.contextmanager
def timed(targets):
    """Wrap each attribute `name` of `module` ((module, name) pairs) so that
    its calls add their wall seconds to the yielded dict under `name`;
    restores the attributes on exit."""
    seconds = dict.fromkeys((name for _, name in targets), 0.0)
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[name] += time.perf_counter() - t
        return run

    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield seconds
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_receiver(torch, dev, card: str) -> dict:
    """Phase 12: the receiver closure, card against CPU, and RTK, on
    captures synthesized by the CUDA kernel, each held byte for byte
    against the plain version's capture of the same scenario on the card.
    Returns the synth_wire launches of this phase (counted from 0) and the
    largest |kernel - plain| sample difference over its captures."""
    import numpy as np

    from gps_sdr_sim_tpu_torch import receiver
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.receiver import acquire, load_iq, pvt, track
    from gps_sdr_sim_tpu_torch.receiver.__main__ import main as rx_main
    from gps_sdr_sim_tpu_torch.receiver.acquire import search, search_prep
    from gps_sdr_sim_tpu_torch.runner import run_simulation
    from gps_sdr_sim_tpu_torch.testing import (
        RX_ACQ_HEADER,
        RX_FS,
        RX_ROVER,
        RX_TRACK_HEADER,
        TOKYO,
        receiver_devices_agree,
        rtk_from_files,
        rx_scenario,
        rx_table,
    )
    from gps_sdr_sim_tpu_torch.tools.card import time_ms

    worst = 0

    def capture(scn) -> tuple[bytes, float]:
        """(SC16 bytes, seconds) of scn through impl="cuda" on the card,
        after checking them against impl="torch" on the card."""
        nonlocal worst
        runs = []
        for impl in ("cuda", "torch"):
            buf = io.BytesIO()
            t = time.perf_counter()
            run_simulation(scn, buf, batch_epochs=16, log=lambda s: None,
                           impl=impl, device=dev)
            runs.append((buf.getvalue(), time.perf_counter() - t))
        got, want = (np.frombuffer(b, np.int16) for b, _ in runs)
        diff = int(np.abs(got.astype(np.int32) - want).max(initial=0))
        worst = max(worst, diff)
        if got.shape != want.shape or diff:
            raise AssertionError(f"the CUDA capture != the plain version's: "
                                 f"{got.shape} {want.shape}, max |diff| "
                                 f"{diff}")
        return runs[0]

    for k in synth.launch_counts:
        synth.launch_counts[k] = 0
    scn = rx_scenario(26.0)
    seg = scn.segments[0]
    visible = sorted(int(p) for p in seg.prn[seg.active])
    base, synth_s = capture(scn)
    if synth.launch_counts["synth_wire"] == 0:
        raise AssertionError("the capture did not come from synth_wire")
    with tempfile.TemporaryDirectory() as tmp:
        path, obs, nav = (pathlib.Path(tmp) / name for name in
                          ("base26.bin", "base.obs", "base.nav"))
        path.write_bytes(base)
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with timed([(receiver, "acquire"), (receiver, "track"),
                    (pvt, "channel_frames"), (pvt, "prepare_observables"),
                    (pvt, "observables"), (pvt, "solve")]) as stage, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = rx_main([str(path), "-s", "2048000", "-b", "16", "--track",
                          "26", "--pvt", "--rinex-obs", str(obs),
                          "--rinex-nav", str(nav)])
        main_s = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"receiver main() exited {rc}:\n"
                                 f"{err.getvalue()[-4000:]}")
        stdout = out.getvalue()
        acquired = sorted(int(r[0]) for r in rx_table(stdout, RX_ACQ_HEADER))
        if acquired != visible:
            raise AssertionError(f"acquired PRNs {acquired} != the visible "
                                 f"set {visible}")
        tracked = rx_table(stdout, RX_TRACK_HEADER)
        no_sbf = [r[0] for r in tracked if int(r[3]) < 1]
        if len(tracked) != len(visible) or no_sbf:
            raise AssertionError(f"channels without a parity-valid "
                                 f"subframe: {no_sbf} of {len(tracked)}")
        ecef = next(ln for ln in stdout.splitlines()
                    if ln.strip().startswith("ECEF"))
        fix_err = float(np.linalg.norm(
            np.array([float(v) for v in ecef.split()[1:4]]) - TOKYO))
        resid = float(re.search(r"max residual ([\d.]+) m", stdout).group(1))
        if fix_err >= 10.0 or resid >= 5.0:
            raise AssertionError(f"PVT fix {fix_err:.2f} m from the true "
                                 f"position, max residual {resid} m")
        decode_pvt_s = sum(stage[k] for k in ("channel_frames",
                                              "prepare_observables",
                                              "observables", "solve"))
        say(f"phase 12 receiver closure: 26 s base capture synthesized by "
            f"the CUDA kernel in {synth_s:.2f} s (= the plain version's "
            f"bytes); receiver main() --track 26 --pvt --rinex-obs "
            f"--rinex-nav on {dev} in {main_s:.2f} s: acquired {acquired} = "
            f"the visible set; {len(tracked)} channels, subframes per channel "
            f"{[int(r[3]) for r in tracked]} (all parity-valid); fix "
            f"{fix_err:.2f} m from the true position, max residual "
            f"{resid:.2f} m")

        # The rover, tracked beside the base's RINEX pair.
        x = load_iq(capture(rx_scenario(26.0, RX_ROVER))[0], 16)
        t = time.perf_counter()
        acq = acquire(x, RX_FS, dopp_step=50.0, device=dev)
        rover_acq_s = time.perf_counter() - t
        t = time.perf_counter()
        rover = track(x, RX_FS, acq, device=dev)
        rover_track_s = time.perf_counter() - t
        t = time.perf_counter()
        rtk = rtk_from_files(rover, obs, nav)
        rtk_s = time.perf_counter() - t
    bl_err = float(np.linalg.norm(rtk.baseline - (RX_ROVER - TOKYO)))
    if not (rtk.fixed and rtk.ratio > 3.0 and bl_err < 0.005
            and rtk.phase_rms < 0.005):
        raise AssertionError(f"RTK: fixed {rtk.fixed}, ratio {rtk.ratio}, "
                             f"baseline error {bl_err * 1e3:.2f} mm, DD "
                             f"phase rms {rtk.phase_rms * 1e3:.2f} mm")
    launches = synth.launch_counts["synth_wire"]
    say(f"phase 12 RTK: rover 26 s synthesized (= the plain version's "
        f"bytes) and tracked on {dev}, against the base's RINEX obs and nav "
        f"from main(): FIX, ratio {rtk.ratio:.1f}, |b| "
        f"{np.linalg.norm(rtk.baseline):.4f} m, fixed-baseline error "
        f"{bl_err * 1e3:.3f} mm, DD phase rms {rtk.phase_rms * 1e3:.3f} mm, "
        f"{rtk.n_sats} sats x {rtk.n_epochs} epochs")

    x2 = load_iq(base, 16, count=int(2.0 * RX_FS))
    t = time.perf_counter()
    agree = receiver_devices_agree(x2, dev)
    say(f"phase 12 card vs CPU, first 2 s ({agree['channels']} channels, "
        f"{len(x2) // 2048} ms): search, acquisition and tracking within "
        f"tolerance (search rel {agree['search_rel']:.3g}, metric rel "
        f"{agree['metric_rel']:.3g}, prompt rel {agree['prompt_rel']:.3g}, "
        f"Doppler {agree['doppler_hz']:.3g} Hz, code phase "
        f"{agree['code_phase_chip']:.3g} chip, prompt sign flips "
        f"{agree['sign_flips']}) in {time.perf_counter() - t:.2f} s")

    # The tracking loop's device busy share: 1 s of the same capture under
    # torch.profiler.
    acq = acquire(x2, RX_FS, dopp_step=50.0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "track.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            track(x2[:int(RX_FS)], RX_FS, acq, device=dev)
        prof.export_chrome_trace(str(path))
        _, kernels, busy, window = read_trace(path)
    if not kernels:
        raise AssertionError("the tracking trace holds no kernel event")
    say(f"phase 12 tracking trace (1000 ms of {sum(a.detected for a in acq)} "
        f"channels under torch.profiler): {len(kernels)} kernel events "
        f"({len(kernels) / 1000:.1f} per tracked ms), {busy / 1e3:.3f} ms of "
        f"kernels in a traced window of {window / 1e3:.3f} ms: kernel busy "
        f"share of the traced window {busy / window:.4f}")

    _, _, codes, dopp, xb = search_prep(x, RX_FS, None, 5000.0, 50.0, 4)
    staged = [torch.from_numpy(v).to(dev) for v in
              (xb, np.fft.fft(codes, axis=-1).astype(np.complex64), dopp)]
    search_ms = time_ms(lambda: search(*staged, RX_FS), 5, dev)
    n_ms = rover.prompt.shape[0]
    acq_ms = [stage["acquire"] * 1e3, rover_acq_s * 1e3]
    track_s = [stage["track"], rover_track_s]
    say(f"phase 12 receiver times on {card}: acquisition (32 PRNs x 201 "
        f"bins x 4 ms, fine Doppler on the host) acquire() base/rover "
        f"{'/'.join(f'{v:.1f}' for v in acq_ms)} ms wall, search on the card "
        f"{search_ms:.3f} ms (CUDA events, best of 5); tracking "
        f"{len(tracked)}/{len(rover.prns)} channels x {n_ms} ms in "
        f"{'/'.join(f'{v:.2f}' for v in track_s)} s = "
        f"{'/'.join(f'{n_ms / v:.0f}' for v in track_s)} ms tracked per "
        f"wall second; decode/PVT (main()'s channel_frames, observables, "
        f"solve) {decode_pvt_s:.2f} s; RTK (rover RINEX write, read, "
        f"solve_baseline) {rtk_s:.2f} s; synth_wire launches in this phase "
        f"{launches}, kernel = plain version on every capture (max |diff| "
        f"{worst})")
    phase_mxu(torch, dev, card, load_iq(base, 16), x2, (xb, codes, dopp),
              search_ms)
    return {"synth_wire": launches, "max_abs_err": worst}


def phase_mxu(torch, dev, card: str, x26, x2, prep, fft_ms: float) -> None:
    """Phase 12, the int8 circulant search (receiver.acquire_mxu) on the
    card: on the 26 s base capture x26 it must detect the PRNs that
    acquire() detects (13), at the same code phases and within 20 Hz; on
    its first 2 s (x2) it must agree with its CPU run within SEARCH_RTOL.
    Times the search on prep, search_prep's (blocks, codes, Doppler grid)
    of the rover, beside the FFT search's fft_ms on them (CUDA events; and
    the host's enqueue alone), its int8 products alone, and acquire_mxu()
    beside acquire(); one search and one pass of the products under
    torch.profiler give the card's busy time and its kernels."""
    from gps_sdr_sim_tpu_torch.receiver import acquire, acquire_mxu
    from gps_sdr_sim_tpu_torch.receiver.acquire_mxu import (
        circulant,
        circulant_index,
        int_mm_padded,
        padded_shape,
        search_inputs,
        search_mxu,
        wipe_int8,
    )
    from gps_sdr_sim_tpu_torch.testing import RX_FS, mxu_devices_agree
    from gps_sdr_sim_tpu_torch.tools.card import (
        HBM_BYTES_PER_S,
        INT8_OPS_PER_S,
        time_ms,
    )

    walls, results = {}, {}
    for fn in (acquire, acquire_mxu, acquire, acquire_mxu):
        t = time.perf_counter()
        results[fn.__name__] = fn(x26, RX_FS, dopp_step=50.0, device=dev)
        walls.setdefault(fn.__name__, []).append(
            (time.perf_counter() - t) * 1e3)
    fft, mxu = results["acquire"], results["acquire_mxu"]
    found = [a.prn for a in fft if a.detected]
    if [a.prn for a in mxu] != [a.prn for a in fft] or len(found) != 13:
        raise AssertionError(f"acquire_mxu PRNs {[a.prn for a in mxu]}, "
                             f"acquire detected {found}")
    for g, f in zip(mxu, fft):
        if g.detected != f.detected or (g.detected and (
                g.code_phase != f.code_phase
                or abs(g.doppler - f.doppler) >= 20.0)):
            raise AssertionError(f"acquire_mxu {g} != acquire {f}")
    dopp_err = max(abs(g.doppler - f.doppler)
                   for g, f in zip(mxu, fft) if g.detected)
    agree = mxu_devices_agree(x2, RX_FS, dev)

    x_re, x_im, codes8, dopp_hz = search_inputs(*prep, dev)

    def search():
        return search_mxu(x_re, x_im, codes8, dopp_hz, RX_FS)

    w8 = wipe_int8(x_re, x_im, dopp_hz, RX_FS)
    idx = circulant_index(x_re.shape[1], dev)
    circs = [circulant(c, idx) for c in codes8]
    row_major = [c.t().contiguous() for c in circs]

    def products():
        return [int_mm_padded(w8, c) for c in circs]

    search_ms = time_ms(search, 5, dev)
    enqueue_ms = time_ms(search, 5, "cpu")  # the host's clock, no wait
    torch.cuda.synchronize()
    mm_ms = time_ms(products, 5, dev)
    mm_row_ms = time_ms(lambda: [torch._int_mm(w8, c) for c in row_major],
                        5, dev)
    traced = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("search", search), ("products", products)):
            path = pathlib.Path(tmp) / f"{name}.json"
            # One pass of warm-up under the profiler, then the pass traced.
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                     active=1),
                    on_trace_ready=lambda p: p.export_chrome_trace(
                        str(path))) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            _, kernels, busy_us, _ = read_trace(path)
            if dev.type == "cuda" and not kernels:
                raise AssertionError(f"the {name} trace holds no kernel")
            by_name = {}
            for e in kernels:
                n, us = by_name.get(e["name"], (0, 0.0))
                by_name[e["name"]] = (n + 1, us + e["dur"])
            traced[name] = (len(kernels), busy_us / 1e3, sorted(
                by_name.items(), key=lambda kv: -kv[1][1])[:4])
    rows, n = padded_shape(*w8.shape)
    ops = 2 * rows * n * n * len(circs)
    bound_ms = ops / INT8_OPS_PER_S * 1e3
    out_mb = rows * n * 4 * len(circs) / 1e6
    say(f"phase 12 acquire_mxu on {dev}: on the 26 s base capture the "
        f"{len(found)} PRNs acquire() detects, same code phases, Doppler "
        f"within {dopp_err:.3g} Hz; card vs CPU on the first 2 s "
        f"({agree['channels']} channels): search rel "
        f"{agree['search_rel']:.3g}, metric rel {agree['metric_rel']:.3g} "
        f"(SEARCH_RTOL)")
    say(f"phase 12 acquire_mxu times on {card}: int8 search (32 PRNs x "
        f"{len(dopp_hz)} bins x 4 ms) {search_ms:.4f} ms beside the FFT "
        f"search's {fft_ms:.4f} ms (CUDA events, best of 5; the host's "
        f"enqueue of one search {enqueue_ms:.4f} ms); its 32 int8 products "
        f"[{rows}, {n}] x [{n}, {n}] alone {mm_ms:.4f} ms (circulant "
        f"column-major; row-major {mm_row_ms:.4f} ms): {ops:,} int8 "
        f"operations, bound {bound_ms:.4f} ms at "
        f"{INT8_OPS_PER_S / 1e12:,.0f} TOPS, share of the bound: products "
        f"{bound_ms / mm_ms:.3f}, search {bound_ms / search_ms:.3f}; int32 "
        f"products {out_mb:.1f} MB "
        f"({out_mb * 1e6 / HBM_BYTES_PER_S * 1e3:.4f} ms written once at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); wall on the base capture, "
        f"first/second call: acquire() "
        f"{'/'.join(f'{v:.1f}' for v in walls['acquire'])} ms, "
        f"acquire_mxu() "
        f"{'/'.join(f'{v:.1f}' for v in walls['acquire_mxu'])} ms")
    for name, (count, busy_ms, top) in traced.items():
        say(f"phase 12 acquire_mxu trace, one {name} pass: {count} kernels, "
            f"card busy {busy_ms:.4f} ms; most time: " + "; ".join(
                f"{k[:60]} x{c} {us / 1e3:.4f} ms" for k, (c, us) in top))


def device_checksum(torch, packed) -> tuple[int, int]:
    """(sum, nonzero) of one packed batch on its device, in the element
    type each format's checksum reads (quantize.pack's output type)."""
    return int(packed.sum(dtype=torch.int64)), int(torch.count_nonzero(packed))


def max_diff(torch, got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def phase_rows_canonical(torch, scn, dev, mesh) -> tuple[dict, dict]:
    """Phase 13a: the canonical workload, planned by plan_batch in
    100-epoch batches, through ops.synth.synth_batch (row kernel, planes)
    and parallel.synth_rows_sharded on `mesh` (raw mode + chan reduction).
    Every launch count is set to 0 just before each batch's two calls and
    read just after; then the batch is held against the plain versions
    (planes, and the raw mode on each chan shard's rows, whose launches are
    not counted). Returns (path launches, max |kernel - plain| by
    kernel)."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.plan import plan_batch
    from gps_sdr_sim_tpu_torch.ops.quantize import pack, wrap_int32
    from gps_sdr_sim_tpu_torch.parallel import synth_rows_sharded
    from gps_sdr_sim_tpu_torch.runner import iter_seg_batches
    from gps_sdr_sim_tpu_torch.tools.bench import golden_checksums

    n = scn.iq_buff_size
    goldens = golden_checksums()
    sums = {key: [0, 0] for key in (16, 8, 1, "2x2")}
    launches = dict.fromkeys(ROW_KERNELS, 0)
    worst = dict.fromkeys(ROW_KERNELS, 0)
    n_chan_dev = len(mesh.grid[0])
    t = time.perf_counter()
    batches = 0
    for seg, e, e1 in iter_seg_batches(scn, 0, scn.n_output_epochs, 100):
        db = plan_batch(seg, e, e1, n, scn.delt)
        for k in synth.launch_counts:
            synth.launch_counts[k] = 0
        iq = synth.synth_batch(db, n, dev)
        iq22 = torch.cat(synth_rows_sharded(db, n, mesh))
        for k in ROW_KERNELS:
            launches[k] += synth.launch_counts[k]
        batches += 1

        rows = synth.upload_rows(synth.pack_rows(db), dev)
        ca = synth.ca_device(db.ca_words, dev)
        plain = torch.stack([p[:, :n] for p in synth.synth_rows_planes_ref(
            rows, ca)], dim=-1)
        worst["synth_rows_planes"] = max(worst["synth_rows_planes"],
                                         max_diff(torch, [iq], [plain]))
        c_loc = rows.shape[2] // n_chan_dev
        for c in range(n_chan_dev):
            part = (rows[:, :, c * c_loc:(c + 1) * c_loc].contiguous(),
                    ca[c * c_loc:(c + 1) * c_loc].contiguous())
            worst["synth_rows_raw"] = max(
                worst["synth_rows_raw"],
                max_diff(torch, synth.synth_rows_raw(*part),
                         synth.synth_rows_raw_ref(*part)))
        if not (torch.equal(iq, plain) and torch.equal(iq22, plain)):
            raise AssertionError(f"row kernel != plain version at epochs "
                                 f"[{e}, {e1}): synth_batch max |diff| "
                                 f"{max_diff(torch, [iq], [plain])}, 2x2 "
                                 f"{max_diff(torch, [iq22], [plain])}")
        for key, samples, fmt in ((16, iq, 16), (8, iq, 8), (1, iq, 1),
                                  ("2x2", iq22, 16)):
            s, nz = device_checksum(torch, pack(samples, fmt))
            sums[key][0] += s
            sums[key][1] += nz
    if worst["synth_rows_raw"]:
        raise AssertionError(f"raw row kernel != plain version: max |diff| "
                             f"{worst['synth_rows_raw']}")
    got = {key: (wrap_int32(s), nz) for key, (s, nz) in sums.items()}
    for key, fmt in ((16, 16), (8, 8), (1, 1), ("2x2", 16)):
        if got[key] != goldens[fmt]:
            raise AssertionError(f"phase 13a {key}: checksum {got[key]} != "
                                 f"golden SC{fmt:02d} {goldens[fmt]}")
    say(f"phase 13a rows canonical: {scn.n_output_epochs} epochs planned by "
        f"plan_batch in {batches} batches of up to 100 epochs "
        f"({time.perf_counter() - t:.2f} s), through synth_batch (row kernel, "
        f"planes) and synth_rows_sharded on a {len(mesh.grid)}x{n_chan_dev} "
        f"mesh of {dev} (raw + chan reduction): every batch = the plain "
        f"version (max |diff| {json.dumps(worst)}); checksums (sum mod 2^32, "
        f"nonzero) SC16 {got[16]}, SC08 {got[8]}, SC01 {got[1]}, 2x2 SC16 "
        f"{got['2x2']} equal the goldens; launches {json.dumps(launches)}")
    return launches, worst


def phase_closed(torch, scns, dev, mesh, wire_stats) -> dict:
    """Phase 13b: the closed impls through run_simulation. Returns the
    real-time factors by label."""
    launches, rt, stats = canonical_runs(
        torch, scns, "phase 13b closed", (16,), impl="closed", device=dev)
    _, rt22, stats22 = canonical_runs(
        torch, scns, "phase 13b closed-sharded 2x2", (16,), formats=(16,),
        impl="closed-sharded", device=dev, mesh=mesh)
    if any(launches.values()):
        raise AssertionError(f"impl closed launched a kernel: {launches}")
    rt22 = rt22[16]
    say(f"phase 13b closed: real-time factor SC16 {rt[16]:.1f}x, "
        f"closed-sharded 2x2 SC16 {rt22:.1f}x (null-sink medians); "
        f"plan_seconds (checksum passes, SC16/SC08/SC01): closed "
        + "/".join(f"{stats[f].plan_seconds:.3f}" for f in FORMATS)
        + ", closed-sharded 2x2 "
        + f"{stats22[16].plan_seconds:.3f}, wire path (phase 6) "
        + "/".join(f"{wire_stats[f].plan_seconds:.3f}" for f in FORMATS)
        + " s (plan_batch rebases on the host; the closed form's launches "
        "are enqueued inside the same timer)")
    return {"closed": rt[16], "closed-sharded 2x2": rt22}


def phase_dryrun(dev) -> None:
    """Phase 13c: entry.dryrun_multichip on a mesh of four entries of this
    card (the JAX package's __graft_entry__ checklist)."""
    from gps_sdr_sim_tpu_torch.entry import dryrun_multichip

    t = time.perf_counter()
    checks = dryrun_multichip(4, [dev] * 4)
    say(f"phase 13c entry.dryrun_multichip(4) on {dev} (2 epochs, 1 Msps, "
        f"{time.perf_counter() - t:.2f} s): " + "; ".join(checks)
        + ": all hold, byte for byte")


def phase_rows_timing(torch, dev) -> dict:
    """Phase 13d: kernel and plain-version ms of each row mode on one
    100-epoch 2.6 Msps batch at the widths phase 13a gives them (planes:
    the 16 DeviceBatch channels; raw: one 8-channel chan shard of the 2x2
    mesh), beside the bound; then the closed form's ms and peak memory on
    the same batch. Returns {name: (ms, plain ms, bound, by)}."""
    from gps_sdr_sim_tpu_torch.ops import synth, synth_closed
    from gps_sdr_sim_tpu_torch.ops.plan import plan_batch
    from gps_sdr_sim_tpu_torch.tools.bench import canonical_scenario
    from gps_sdr_sim_tpu_torch.tools.card import (
        bound_ms,
        synth_operations,
        time_ms,
    )

    scn = canonical_scenario(16)
    n = scn.iq_buff_size
    db = plan_batch(scn.segments[0], 0, 100, n, scn.delt)
    rows = synth.upload_rows(synth.pack_rows(db), dev)
    ca = synth.ca_device(db.ca_words, dev)
    modes = (("synth_rows_planes", rows, ca, synth.synth_rows_planes,
              synth.synth_rows_planes_ref),
             ("synth_rows_raw", rows[:, :, :8].contiguous(),
              ca[:8].contiguous(), synth.synth_rows_raw,
              synth.synth_rows_raw_ref))
    times = {}
    for name, r, c, kernel, plain in modes:
        got, want = kernel(r, c), plain(r, c)
        if max_diff(torch, got, want):
            raise AssertionError(f"{name} != plain version on the 100-epoch "
                                 f"batch")
        out_bytes = sum(a.numel() * a.element_size() for a in got)
        del got, want
        ms = time_ms(lambda: kernel(r, c), 20, dev)
        plain_ms = time_ms(lambda: plain(r, c), 2, dev, warm=False)
        # The data needs the (epoch, channel) pairs whose gain is not 0.
        pairs = int((r[:, 0, :, 11] != 0).sum())
        in_bytes = r.numel() * 4 + c.numel() * 4 + 2 * 512 * 4
        ops = synth_operations(pairs * n, r.shape[0] * n,
                               name == "synth_rows_planes")
        bound, by = bound_ms(in_bytes, out_bytes, ops)
        times[name] = (ms, plain_ms, bound, by)
        say(f"phase 13d timing {name}: {r.shape[0]} epochs x {n} samples x "
            f"{r.shape[2]} channels ({pairs} (epoch, channel) pairs with "
            f"gain), {r.numel() * 4} bytes of rows: kernel {ms:.4f} ms "
            f"({r.shape[0] * n / ms / 1e6:.3f} Gsamples/s; best of 20), plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by} ({ops} "
            f"operations, {out_bytes} bytes out; {bound / ms:.1%} of it; "
            f"{share_without_wrap(ops, pairs * n, ms):.1%} at 13 operations "
            f"per pair), kernel = plain bit for bit")
    # The closed form on the same batch: what impl closed spends per batch.
    tensors = synth_closed.batch_tensors(db, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    closed_ms = time_ms(lambda: synth_closed.synth_iq16(*tensors, n_out=n),
                        3, dev)
    say(f"phase 13d timing closed form (plain torch, impl closed): the same "
        f"batch, all 16 channels, {closed_ms:.3f} ms (best of 3), peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return times


def phase_scaling(dev) -> None:
    """Phase 13e: tools/bench_scaling over meshes of 1, 2 and 4 entries,
    each repeating this card."""
    from gps_sdr_sim_tpu_torch.tools import bench_scaling

    for impl in bench_scaling.IMPLS:
        rows = bench_scaling.sweep(impl, dev, repeat_devices=[1, 2, 4])
        say(f"phase 13e bench_scaling --impl {impl} --repeat-devices 1,2,4: "
            + "; ".join(f"{r['devices']} entries ({r['distinct_devices']} "
                        f"distinct) {r['value']} Msamples/s, efficiency "
                        f"{r['efficiency_vs_1dev']}" for r in rows)
            + f"; {rows[0]['device_name']}, {rows[0]['power_limit']}")


def phase_day(torch, dev) -> dict:
    """Phase 14: the full day through dayrun.synth_day at the tool's
    defaults, held to DAYRUN_r05.json, with the launch counts set to 0 just
    before and read just after; then the plain version on each batch that
    holds a sampled block. Returns {"synth_wire": launches, "max_abs_err":
    max |kernel - plain|}."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.quantize import words_to_bytes
    from gps_sdr_sim_tpu_torch.tools import dayrun, deepcheck

    want = json.loads((ROOT / "DAYRUN_r05.json").read_text())
    cfg = deepcheck.static_config(2.6e6, 86400.0)
    for k in synth.launch_counts:
        synth.launch_counts[k] = 0
    run = dayrun.synth_day(cfg, device=dev, keep_block_batches=True,
                           log=lambda s: None)
    launches = dict(synth.launch_counts)
    st = run.stats
    for key in ("epochs", "total_samples", "batch_epochs", "sampled_blocks",
                "checksum_wrapped_int32", "min_batch_nonzero",
                "block_sha256"):
        if st[key] != want[key]:
            raise AssertionError(f"phase 14: {key} {st[key]} != "
                                 f"DAYRUN_r05.json's {want[key]}")
    # One launch per batch, and the one that warms the kernel up.
    if launches["synth_wire"] != st["batches"] + 1 or any(
            v for k, v in launches.items() if k != "synth_wire"):
        raise AssertionError(f"phase 14: launches {launches} for "
                             f"{st['batches']} batches")

    t = time.perf_counter()
    n, fmt = st["iq_buff_size"], st["fmt"]
    blocks = [tuple(b) for b in st["sampled_blocks"]]
    worst, plain_parts = 0, {}
    for staged, out_lo, valid in run.block_batches:
        plain = synth.synth_staged_packed(staged, n, fmt, plain=True)
        worst = max(worst, max_diff(torch, [synth.synth_staged_packed(
            staged, n, fmt)], [plain]))
        for blo, r0, r1 in dayrun.block_slices(blocks, out_lo,
                                               out_lo + valid):
            plain_parts.setdefault(blo, []).append(bytes(words_to_bytes(
                plain[r0:r1].cpu().numpy(), n, fmt)))
        del plain
    plain_sha = {str(lo): hashlib.sha256(b"".join(p)).hexdigest()
                 for lo, p in plain_parts.items()}
    same_sha = plain_sha == st["block_sha256"]
    if worst or not same_sha:
        raise AssertionError(f"phase 14: kernel != plain version on the "
                             f"block batches (max |diff| {worst}; block "
                             f"sha256 equal: {same_sha})")
    plain_s = time.perf_counter() - t

    rates = [r["interval_gsps"] for r in st["throughput_timeline"]]
    say(f"phase 14 day run: {st['epochs']} epochs, {st['total_samples']} "
        f"samples (86,400 s, 2.6 Msps, SC16) in {st['batches']} batches of "
        f"{st['batch_epochs']} through dayrun.synth_day on {dev}: checksum "
        f"(wrapped int32) {st['checksum_wrapped_int32']}, min batch nonzero "
        f"{st['min_batch_nonzero']} and the sha256 of all "
        f"{len(st['block_sha256'])} sampled blocks equal DAYRUN_r05.json's; "
        f"wall {st['wall_s']:.3f} s, plan_s {st['plan_s']:.3f} s (producer "
        f"thread), build {st['build_s']:.3f} s, warm {st['warm_s']:.3f} s, "
        f"real-time factor {st['realtime_factor']:.1f}x, "
        f"{st['samples_per_s']:.3f} Gsamples/s; timeline "
        f"({len(rates)} drains) min/median/max "
        f"{st['interval_gsps_min']:.3f}/{st['interval_gsps_median']:.3f}/"
        f"{st['interval_gsps_max']:.3f} Gsamples/s; kernel "
        f"{st['kernel_s']:.3f} s by CUDA events, busy share "
        f"{st['kernel_busy_share'] * 100:.2f}% of wall; peak RSS "
        f"{st['peak_rss_mb']:.0f} MB; synth_wire launches "
        f"{launches['synth_wire']} ({st['batches']} batches + 1 warm-up); "
        f"the {len(run.block_batches)} block batches = the plain version on "
        f"the card (max |diff| {worst}, same block sha256; "
        f"{plain_s:.2f} s); {st['card']}")
    return {"synth_wire": launches["synth_wire"], "max_abs_err": worst,
            "realtime_factor": st["realtime_factor"]}


def phase_bench(card: str) -> None:
    """Phase 15: tools/bench as a subprocess through IMPORT_HOOK, one
    session of each of BENCH_IMPLS at the canonical size."""
    t0 = time.perf_counter()
    for impl, kernel in BENCH_IMPLS.items():
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", BENCH, "--impl", impl],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"bench --impl {impl} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = proc.stdout.splitlines()
        if len(lines) != 1:
            raise AssertionError(f"bench --impl {impl} printed "
                                 f"{len(lines)} lines on stdout")
        line = json.loads(lines[0])
        unverified = [f for f, v in line["formats"].items()
                      if v["checksum_verified"] is not True]
        if line["checksum_verified"] is not True or unverified:
            raise AssertionError(f"bench --impl {impl}: checksum_verified "
                                 f"{line['checksum_verified']}, not true in "
                                 f"{unverified}")
        if line["card"] != card:
            raise AssertionError(f"bench --impl {impl}: card "
                                 f"{line['card']!r} != {card!r}")
        launched = {k: v for k, v in line["launches"].items() if v}
        if set(launched) != ({kernel} if kernel else set()):
            raise AssertionError(f"bench --impl {impl} launched {launched}")
        say(f"phase 15 bench --impl {impl} ({time.perf_counter() - t:.2f} "
            f"s): {lines[0]}")
    say(f"phase 15 bench: " + ", ".join(BENCH_IMPLS) + " exit 0, "
        f"checksum_verified true in SC16, SC08 and SC01 against "
        f"tests/golden/bench_checksum.txt, card = phase 1's; "
        f"{time.perf_counter() - t0:.2f} s")


def player_pipe(tmp: pathlib.Path, cli_args: list,
                pairs: int) -> tuple[int, int]:
    """The CLI's SC08 -o - (static Tokyo, `cli_args`) through tee into a
    file and into tools/uhd_player --sink; raises unless the capture holds
    `pairs` I/Q pairs, not all 0, and the sink is their NumPy decode (x16
    / 2048). Returns (capture bytes, sink samples)."""
    import numpy as np

    from gps_sdr_sim_tpu_torch.testing import NAV

    cap, sink = tmp / "player.bin", tmp / "player.fc32"
    cli = subprocess.Popen(
        [sys.executable, "-c", CLI, "-e", str(NAV), "-l",
         "35.681298,139.766247,10.0", *cli_args, "-b", "8", "-o", "-"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    tee = subprocess.Popen(["tee", str(cap)], stdin=cli.stdout,
                           stdout=subprocess.PIPE)
    cli.stdout.close()
    player = subprocess.run(
        [sys.executable, "-c", tool("tools.uhd_player"), "-t", "/dev/stdin",
         "-b", "8", "--no-repeat", "--sink", str(sink)],
        cwd=ROOT, stdin=tee.stdout, capture_output=True, text=True,
        timeout=600)
    tee.stdout.close()
    rcs = (cli.wait(timeout=600), tee.wait(timeout=60), player.returncode)
    if rcs != (0, 0, 0):
        raise AssertionError(f"CLI | tee | uhd_player exited {rcs}:\n"
                             f"{player.stderr[-4000:]}")
    raw = np.fromfile(cap, np.int8)
    iq = raw.astype(np.float32).reshape(-1, 2) * 16.0
    want = ((iq[:, 0] + 1j * iq[:, 1]) / 2048.0).astype(np.complex64)
    got = np.fromfile(sink, np.complex64)
    if iq.shape[0] != pairs or not raw.any():
        raise AssertionError(f"the CLI wrote {iq.shape[0]} I/Q pairs "
                             f"({np.count_nonzero(raw)} bytes not 0), "
                             f"not {pairs}")
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.flatnonzero(got != want)[:5] if got.shape == want.shape
               else [])
        raise AssertionError(f"uhd_player --sink: {got.size} samples for "
                             f"{want.size}; first differing at {bad}: "
                             f"{got[bad]} != {want[bad]}")
    return raw.size, got.size


def phase_attribution(torch, dev, card: str) -> None:
    """Phase 16: the ablated instantiations against their plain versions,
    tools/profile_kernel and tools/op_budget as subprocesses, and the
    CLI's -o - through tools/uhd_player --sink."""
    from gps_sdr_sim_tpu_torch.ops import synth, synth_cuda
    from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
    from gps_sdr_sim_tpu_torch.tools import op_budget, profile_kernel
    from gps_sdr_sim_tpu_torch.tools.bench import canonical_scenario

    t0 = time.perf_counter()
    lib = synth_cuda.build(synth_cuda.PROFILE_SOURCE)
    found = op_budget.budget(synth_cuda.sass(lib), synth_cuda.build_log(lib),
                             "synth_profile")
    for key, b in found.items():
        u = b["ptxas"]
        say(f"phase 16 {key}: {b['sass_per_chan_sample']:.3f} SASS "
            f"instructions per (sample, channel) ({b['body_per_sample']} per "
            f"sample + {b['setup_per_trip']} setup per trip); -Xptxas -v: "
            f"{u['registers']} registers, spill stores {u['spill_stores']} "
            f"/ loads {u['spill_loads']} bytes")

    scn = canonical_scenario(16)
    staged = synth.stage_epochs(
        plan_epochs(scn.segments[0], 0, 100, scn.delt), dev)
    n = scn.iq_buff_size
    args = (staged.wire, staged.ca_words, staged.n_chan, n)
    profile_kernel.launch_counts["synth_wire_ablated"] = 0
    worst, differ = 0, 0
    for fmt in FORMATS:
        production = synth.synth_wire(*args, fmt)
        for name, ablate in synth_cuda.ABLATION_SETS.items():
            got = profile_kernel.synth_wire_ablated(*args, fmt, ablate)
            want = synth.schedule_words(*args, fmt, ablate)
            worst = max(worst, max_diff(torch, (got,), (want,)))
            if not torch.equal(got, want):
                raise AssertionError(f"synth_wire/{fmt}/{name} != its plain "
                                     f"version on the 100-epoch batch")
            differ += not torch.equal(got, production)
            del got, want
    launches = profile_kernel.launch_counts["synth_wire_ablated"]
    if launches != len(FORMATS) * len(synth_cuda.ABLATION_SETS):
        raise AssertionError(f"{launches} ablated launches")
    say(f"phase 16 ablated kernels: all {launches} (SC16/SC08/SC01 x "
        f"{', '.join(synth_cuda.ABLATION_SETS)}) = their plain versions "
        f"(schedule_words) on the canonical 100-epoch batch, max |diff| "
        f"{worst}; {differ} of them differ from the production words")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        lines = {}
        for module, extra in (
                ("profile_kernel", ["--json", str(tmp / "profile.json")]),
                ("op_budget", ["--profile", str(tmp / "profile.json"),
                               "--json", str(tmp / "budget.json")])):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", tool(f"tools.{module}"), *extra],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            out = proc.stdout.splitlines()
            if proc.returncode != 0 or len(out) != 1:
                raise AssertionError(f"{module} exited {proc.returncode} "
                                     f"with {len(out)} lines:\n"
                                     f"{proc.stderr[-4000:]}")
            lines[module] = json.loads(out[0])
            say(f"phase 16 {module} ({time.perf_counter() - t:.2f} s): "
                f"{out[0]}")
        prof, budget = lines["profile_kernel"], lines["op_budget"]
        if prof["card"] != card or budget["card"] != card:
            raise AssertionError(f"card {prof['card']!r} / "
                                 f"{budget['card']!r} != {card!r}")
        for key in ("overhead_separation", "breakdown", "epilogue"):
            if not prof.get(key):
                raise AssertionError(f"profile_kernel printed no {key}")
        full = json.loads((tmp / "budget.json").read_text())
        b = full["instantiations"]["synth_wire/16"]
        say(f"phase 16 op_budget synth_wire/16 per (sample, channel): "
            + ", ".join(f"{c} {v:.3f}" for c, v in
                        b["classes_per_chan_sample"].items() if v)
            + f"; body {json.dumps(b['classes_body_per_sample'])}, setup "
            f"per trip {json.dumps(b['classes_setup_per_trip'])}; "
            f"reconcile {json.dumps(full['reconcile'])}")

        t = time.perf_counter()
        # 19 epochs of 0.1 s: the CLI writes -d 2 as the reference does.
        size, pairs = player_pipe(tmp, ["-d", "2", "-s", "2600000"],
                                  19 * 260000)
        say(f"phase 16 CLI -o - | uhd_player --sink: a 2 s SC08 capture "
            f"({size} bytes, {time.perf_counter() - t:.2f} s) gives {pairs} "
            f"fc32 samples = the NumPy decode (x16 / 2048)")
    say(f"phase 16 attribution: {time.perf_counter() - t0:.2f} s")


def read_log(log: pathlib.Path) -> list:
    """The JSON lines that counted() programs appended to `log`."""
    return [json.loads(ln) for ln in log.read_text().splitlines()]


def phase_fuzz() -> dict:
    """Phase 17: the FORCED cases of fuzz_oracle's seed 0 through run_case,
    FUZZ_WORKERS at a time, the CLI's kernel against its plain version on
    the card. Returns synth_wire's launches and the largest |diff|."""
    from gps_sdr_sim_tpu_torch.tools import fuzz_oracle

    cases = fuzz_oracle.gen_cases(len(fuzz_oracle.FORCED), 0)

    def run(k: int, td: pathlib.Path) -> tuple:
        tmp = td / str(k)
        tmp.mkdir()
        case = cases[k]
        ours = [sys.executable, "-c", counted("cli", tmp / "cuda.jsonl"),
                "--impl", "cuda", "--device", "cuda"]
        plain = [sys.executable, "-c", counted("cli", tmp / "torch.jsonl"),
                 "--impl", "torch", "--device", "cuda"]
        if case["fixed_carr"]:
            plain += ["--carrier-phase", "fixed"]
        r = fuzz_oracle.run_case(case, ours, plain, tmp, timeout=600)
        return (r, read_log(tmp / "cuda.jsonl")[0]["launches"],
                read_log(tmp / "torch.jsonl")[0]["launches"])

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            ThreadPoolExecutor(FUZZ_WORKERS) as pool:
        done = list(pool.map(run, range(len(cases)),
                             [pathlib.Path(td)] * len(cases)))
    wall = time.perf_counter() - t0
    launches, samples, worst = 0, 0, 0
    for k, (r, cuda, plain) in enumerate(done):
        equal = (r.get("pass") is True and r["size_match"]
                 and r["stderr_match"] and r["mismatch_fraction"] == 0
                 and r["max_delta"] == 0)
        if not equal:
            raise AssertionError(f"phase 17 case {k}: the kernel's CLI run "
                                 f"!= its plain version's: {json.dumps(r)}")
        if {name for name, n in cuda.items() if n} != {"synth_wire"} or \
                any(plain.values()):
            raise AssertionError(f"phase 17 case {k}: launches {cuda} "
                                 f"(cuda), {plain} (torch)")
        launches += cuda["synth_wire"]
        samples += r["samples"]
        worst = max(worst, r["max_delta"])
        argv = " ".join(r["argv"]).replace(f"{ROOT}/", "")
        say(f"phase 17 case {k} ({r['carrier']} carrier): {argv}: "
            f"{r['samples']} values equal, stderr equal; cuda "
            f"{r['ours_s']:.2f} s, torch {r['oracle_s']:.2f} s; synth_wire "
            f"launches {cuda['synth_wire']}")
    say(f"phase 17 fuzz: {len(done)} cases of seed 0 (8 short, 8 of 31-95 "
        f"s), {samples} values, every byte and canonical stderr line of "
        f"--impl cuda = --impl torch on the card, {FUZZ_WORKERS} at a time; "
        f"{launches} synth_wire launches; {wall:.2f} s")
    return {"synth_wire": launches, "max_abs_err": worst}


def phase_rtk() -> dict:
    """Phase 18: tools/rtk_oracle as a subprocess through IMPORT_HOOK, its
    --oracle a wrapper that runs the CLI with --impl cuda; then each of its
    captures again by the plain version on the card. Returns synth_wire's
    launches and the largest |diff| (0: equal hashes)."""
    from gps_sdr_sim_tpu_torch.cli import main as cli_main

    want = json.loads((ROOT / "RTK_ORACLE_r02.json").read_text())["closures"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        log, wrapper = tmp / "oracle.jsonl", tmp / "gps-sdr-sim"
        wrapper.write_text(f"#!{sys.executable}\n" + counted(
            "cli", log, ["--impl", "cuda"], hash_output=True))
        wrapper.chmod(0o755)
        proc = subprocess.run(
            [sys.executable, "-c", tool("tools.rtk_oracle"), "--oracle",
             str(wrapper), "--json", str(tmp / "rtk.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
            env={**os.environ, "TMPDIR": str(tmp)})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"rtk_oracle exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        got = json.loads((tmp / "rtk.json").read_text())["closures"]
        calls = read_log(log)
        t = time.perf_counter()
        plain = tmp / "plain.bin"
        for c in calls:
            argv = list(c["argv"])
            argv[argv.index("-o") + 1] = str(plain)
            with contextlib.redirect_stderr(io.StringIO()):
                rc = cli_main(argv + ["--impl", "torch"])
            with open(plain, "rb") as f:
                sha = hashlib.file_digest(f, "sha256").hexdigest()
            plain.unlink()
            if rc != 0 or sha != c["sha256"]:
                raise AssertionError(f"phase 18: the plain version's capture "
                                     f"of {argv} (exit {rc}) != the kernel's")
        plain_s = time.perf_counter() - t
    st, kn = got["static"], got["kinematic"]
    if not (st["fixed"] and st["fixed_error_mm"] < 10 and st["pass"]
            and kn["fixed"] and kn["track_err_max_mm"] < 50 and kn["pass"]):
        raise AssertionError(f"phase 18: closures {json.dumps(got)}")
    launches = [c["launches"] for c in calls]
    if len(calls) != 4 or any(
            {name for name, k in n.items() if k} != {"synth_wire"}
            for n in launches):
        raise AssertionError(f"phase 18: {len(calls)} oracle runs, "
                             f"launches {launches}")
    n = sum(x["synth_wire"] for x in launches)
    ws, wk = want["static"], want["kinematic"]
    say(f"phase 18 RTK static: fixed, error {st['fixed_error_mm']} mm "
        f"(C oracle {ws['fixed_error_mm']}), ratio {st['ratio']} "
        f"({ws['ratio']}), DD phase rms {st['dd_phase_rms_mm']} mm "
        f"({ws['dd_phase_rms_mm']}), {st['n_sats']} satellites, "
        f"{st['n_epochs']} epochs, {st['n_slips']} slips")
    say(f"phase 18 RTK kinematic: fixed, worst {kn['track_err_max_mm']} mm "
        f"(C oracle {wk['track_err_max_mm']}), mean "
        f"{kn['track_err_mean_mm']} mm ({wk['track_err_mean_mm']}), ratio "
        f"{kn['ratio']} ({wk['ratio']}), DD phase rms "
        f"{kn['dd_phase_rms_mm']} mm ({wk['dd_phase_rms_mm']}), "
        f"{kn['n_sats']} satellites, {kn['n_epochs']} epochs, "
        f"{kn['n_slips']} slips")
    say(f"phase 18 RTK: four 26 s SC16 captures at 2.048 Msps by the CUDA "
        f"kernel ({n} synth_wire launches; each = the plain version's on "
        f"the card by sha256, {plain_s:.2f} s), tracked on the card; "
        f"rtk_oracle {wall:.2f} s")
    return {"synth_wire": n, "max_abs_err": 0}


def main() -> int:
    if not (ROOT / KERNEL_SOURCE).is_file():
        print(f"FAIL: {KERNEL_SOURCE} not found beside chip_smoke.py; run "
              f"it from a checkout of the repository", file=sys.stderr)
        return 1
    exec(IMPORT_HOOK, {})
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_env(torch)
    dev = torch.device("cuda", 0)
    sass_ops = phase_build()
    max_err = phase_kernel_vs_plain(torch, dev)
    phase_goldens(dev)
    phase_cli()
    from gps_sdr_sim_tpu_torch.tools.bench import canonical_scenario

    scns = {fmt: canonical_scenario(fmt) for fmt in FORMATS}
    launches, rt, wire_stats = canonical_runs(
        torch, scns, "phase 6 canonical", FORMATS, impl="cuda", device=dev)
    from gps_sdr_sim_tpu_torch.parallel import make_mesh

    meshes = (("1x1", make_mesh(1, 1, [dev])),
              ("2x2", make_mesh(2, 2, [dev] * 4)))
    nav_launches, nav_rt, nav_sharded = phase_nav_canonical(
        torch, scns, dev, meshes)
    times, ratios = phase_timing(torch, dev)
    sharded = {}
    for label, mesh in meshes:
        sharded[label] = canonical_runs(
            torch, scns, f"phase 8 cuda-sharded {label}", (16,),
            impl="cuda-sharded", mesh=mesh)
    phase_shard_files(torch, dev)
    vpu = phase_vpu_peak(sass_ops)
    phase_profile(dev)
    rx = phase_receiver(torch, dev, card)
    row_launches, row_err = phase_rows_canonical(torch, scns[16], dev,
                                                 meshes[1][1])
    closed_rt = phase_closed(torch, scns, dev, meshes[1][1], wire_stats)
    phase_dryrun(dev)
    row_times = phase_rows_timing(torch, dev)
    phase_scaling(dev)
    day = phase_day(torch, dev)
    phase_bench(card)
    phase_attribution(torch, dev, card)
    fuzz = phase_fuzz()
    rtk = phase_rtk()

    # Each kernel's launches on the path that runs it.
    paths = {"synth_wire": launches["synth_wire"] + rx["synth_wire"]
             + day["synth_wire"] + fuzz["synth_wire"] + rtk["synth_wire"],
             "synth_wire_planes": sharded["1x1"][0]["synth_wire_planes"],
             "synth_wire_raw": sharded["2x2"][0]["synth_wire_raw"],
             "synth_wire_nav": nav_launches["synth_wire_nav"],
             "synth_wire_planes_nav":
                 nav_sharded["1x1"][0]["synth_wire_planes_nav"],
             "synth_wire_raw_nav":
                 nav_sharded["2x2"][0]["synth_wire_raw_nav"],
             "vpu_peak": vpu["launches"], **row_launches}
    for name, count in paths.items():
        if count == 0:
            raise AssertionError(f"the main path launched no {name}")
    say(f"summary: real-time factor " + ", ".join(
        f"SC{f:02d} {rt[f]:.1f}x" for f in FORMATS) + "; cuda-sharded SC16 "
        + ", ".join(f"{label} {r[1][16]:.1f}x" for label, r in
                    sharded.items())
        + f"; with the mask table SC16 {nav_rt[16]:.1f}x, cuda-sharded SC16 "
        + ", ".join(f"{label} {r[1][16]:.1f}x" for label, r in
                    nav_sharded.items())
        + "; A/B b_over_a (mask table / walk) " + ", ".join(
            f"{k} {r:.4f}" for k, r in ratios.items())
        + "; DeviceBatch path " + ", ".join(
            f"{k} {r:.1f}x" for k, r in closed_rt.items())
        + f"; day run (86,400 s, SC16) {day['realtime_factor']:.1f}x on "
        f"{card}")
    say(card)
    report = []
    for name, replaces in KERNELS.items():
        packed = name in ("synth_wire", "synth_wire_nav")
        key = f"{name}/16" if packed else name
        ms, plain_ms, bound, by = times[key]
        row = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
               "replaces": replaces, "launches": paths[name],
               "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "design": DESIGN}
        if name == "synth_wire":
            row["max_abs_err"] = max(max_err[name], rx["max_abs_err"],
                                     day["max_abs_err"], fuzz["max_abs_err"],
                                     rtk["max_abs_err"])
            row["launches_by_path"] = {
                "phase 6 canonical": launches["synth_wire"],
                "phase 12 receiver": rx["synth_wire"],
                "phase 14 day run": day["synth_wire"],
                "phase 17 fuzz": fuzz["synth_wire"],
                "phase 18 RTK": rtk["synth_wire"]}
            row["max_abs_err_by_path"] = {
                "phase 3 kernel vs plain": max_err[name],
                "phase 12 receiver": rx["max_abs_err"],
                "phase 14 day run": day["max_abs_err"],
                "phase 17 fuzz": fuzz["max_abs_err"],
                "phase 18 RTK": rtk["max_abs_err"]}
        if packed:
            for field, i in (("ms", 0), ("plain_ms", 1), ("bound_ms", 2)):
                row[f"{field}_by_format"] = {
                    str(f): times[f"{name}/{f}"][i] for f in FORMATS}
        report.append(row)
    report.append({"name": "vpu_peak", "route": "cuda",
                   "source": VPU_PEAK_SOURCE, "replaces": VPU_PEAK_REPLACES,
                   "launches": vpu["launches"],
                   "max_abs_err": vpu["max_abs_err"], "ms": vpu["ms"],
                   "plain_ms": vpu["plain_ms"], "bound_ms": vpu["bound_ms"],
                   "bound_by": vpu["bound_by"], "library_ms": None})
    for name, replaces in ROW_KERNELS.items():
        ms, plain_ms, bound, by = row_times[name]
        report.append({"name": name, "route": "cuda",
                       "source": KERNEL_SOURCE, "replaces": replaces,
                       "launches": paths[name], "max_abs_err": row_err[name],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": None,
                       "design": DESIGN})
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
