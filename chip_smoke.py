#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gps_sdr_sim_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

An import hook installed first makes any import of jax or of the JAX
package (gps_sdr_sim_tpu) raise, here and in the CLI processes it starts,
so the run shows that the port stands alone. Phases, each printing one line
of findings (any failure raises and exits non-zero):

 1. environment: card name and power limit, CUDA, nvcc, triton;
 2. build csrc/synth.cu with nvcc for sm_90a (timed as set-up), and count
    each kernel mode's instructions per (sample, channel) in its SASS;
 3. the kernel's three modes (packed words, int16 planes, raw int32 sums)
    against their plain PyTorch versions on the card, word for word: four
    sample rates, the highalt16 and staticfix16 configurations, and seeded
    random wires; the planes, interleaved, must be the SC16 words;
 4. the 11 C-reference IQ goldens through run_simulation(impl="cuda");
 5. the CLI end to end as a subprocess, checked against golden static16;
 6. the canonical workload (circle.csv, 300 s, 2.6 Msps, SC16/SC08/SC01)
    through run_simulation(impl="cuda"): (sum, nonzero) must equal
    tests/golden/bench_checksum.txt exactly; the median of three passes
    into a null sink gives the real-time factor;
 7. kernel and plain-version times of each mode on one 100-epoch 2.6 Msps
    batch, beside each mode's bound;
 8. the canonical workload through run_simulation(impl="cuda-sharded") on a
    1x1 mesh (planes mode) and on a 2x2 mesh with every entry on this card
    (raw mode and the chan reduction): the same checksums; a null-sink
    median of three for SC16;
 9. shard files: 30 s of the canonical scenario as 4 shards, concatenated,
    equal the single-file run; a truncated shard is restored by resume;
    two CLI processes joined by --multihost write the same bytes.

The line before the last is the kernel report; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import time

# Installed before anything of the port is imported; given to every CLI
# process this script starts.
IMPORT_HOOK = """
import importlib.abc, sys
class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "gps_sdr_sim_tpu"):
            raise ImportError(f"the port imported {name}")
sys.meta_path.insert(0, _NoJax())
"""
CLI = IMPORT_HOOK + (
    "import runpy; runpy.run_module('gps_sdr_sim_tpu_torch.cli', "
    "run_name='__main__')")

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCE = "gps_sdr_sim_tpu_torch/csrc/synth.cu"
# Each mode's wrapper (the launch-count key) and the Pallas code it replaces.
KERNELS = {
    "synth_wire": "gps_sdr_sim_tpu/ops/synth_pallas.py:171",
    "synth_wire_planes": "gps_sdr_sim_tpu/ops/synth_pallas.py:497",
    "synth_wire_raw": "gps_sdr_sim_tpu/ops/synth_pallas.py:500",
}
RATES = (1.0e6, 1310720.0, 1331200.0, 2.6e6)
FORMATS = (16, 8, 1)
# NVIDIA H100 SXM at its 700 W limit (published peak rates): HBM3 rate, and one 32-bit instruction per lane per clock on every
# scheduler, i.e. the 67 TFLOP/s float32 rate counted in FMAs.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2


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


def sass_loop_instructions(sass: str) -> dict:
    """Instructions in each kernel instantiation's channel loop, from the
    text of `cuobjdump -sass`: the innermost loop (backward branch) whose
    body holds an IMAD.HI, the multiply-high that the floor divisions by
    1023 and 20 compile to. The loop is kept rolled (csrc/synth.cu), so its
    length is what one (sample, channel) issues. Keys: synth_wire/16,
    synth_wire/8, synth_wire/1, synth_wire_planes, synth_wire_raw."""
    names = {("0", "16"): "synth_wire/16", ("0", "8"): "synth_wire/8",
             ("0", "1"): "synth_wire/1", ("1", "0"): "synth_wire_planes",
             ("2", "0"): "synth_wire_raw"}
    counts = {}
    for block in re.split(r"Function : ", sass)[1:]:
        m = re.match(r"\S*synth_wire_kernelILi(\d)ELi(\d+)E", block)
        if not m:
            continue
        ins = [(int(a, 16), op.split()) for a, op in re.findall(
            r"/\*([0-9a-f]{4})\*/\s+([^;]*);", block)]
        index = {a: i for i, (a, _) in enumerate(ins)}
        best = None
        for i, (a, op) in enumerate(ins):
            opcode = op[1:] if op and op[0].startswith("@") else op
            if not opcode or opcode[0] != "BRA" or len(opcode) < 2:
                continue
            target = int(opcode[1].strip("`()"), 16)
            if target >= a or target not in index:
                continue
            body = [o for _, o in ins[index[target]:i + 1]]
            ops = [o[1] if o[0].startswith("@") else o[0] for o in body]
            if any(o.startswith("IMAD.HI") for o in ops):
                n = sum(o != "NOP" for o in ops)
                best = n if best is None else min(best, n)
        if best is None:
            raise AssertionError(f"no channel loop found in {block[:80]}")
        counts[names[m.groups()]] = best
    if sorted(counts) != sorted(names.values()):
        raise AssertionError(f"SASS holds kernels {sorted(counts)}")
    return counts


def phase_build() -> dict:
    """Returns sass_loop_instructions of the built library."""
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    t = time.perf_counter()
    lib = synth_cuda.build(verbose=True)
    synth_cuda.load()
    built = time.perf_counter() - t
    tool = pathlib.Path(synth_cuda.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = sass_loop_instructions(sass)
    say(f"phase 2 build: {lib.name} in {built:.2f} s; SASS channel-loop "
        f"instructions per (sample, channel): {json.dumps(ops)}")
    return ops


def phase_kernel_vs_plain(torch, dev) -> dict:
    """Returns each kernel's largest |kernel - plain| over all outputs."""
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

    def compare(wire, ca, n_chan, n_out, label):
        for fmt in FORMATS:
            got = synth.synth_wire(wire, ca, n_chan, n_out, fmt)
            check("synth_wire", [got],
                  [synth.synth_wire_ref(wire, ca, n_chan, n_out, fmt)],
                  f"{label} fmt {fmt}")
            if fmt == 16:
                sc16 = got
        planes = synth.synth_wire_planes(wire, ca, n_chan, n_out)
        check("synth_wire_planes", planes,
              synth.synth_wire_planes_ref(wire, ca, n_chan, n_out), label)
        check("synth_wire_raw", synth.synth_wire_raw(wire, ca, n_chan, n_out),
              synth.synth_wire_raw_ref(wire, ca, n_chan, n_out), label)
        torch.cuda.synchronize()
        if not torch.equal(torch.stack(planes, dim=-1).reshape(
                wire.shape[0], -1), sc16.view(torch.int16)):
            raise AssertionError(f"planes interleaved != SC16 words: {label}")

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
        compare(*staged, scn.iq_buff_size, label)
    for seed in range(8):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        compare(torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev),
                n_chan, 5000, f"random seed {seed}")
    for k in KERNELS:
        launched = synth.launch_counts[k] - before[k]
        if launched != calls[k]:
            raise AssertionError(f"{k}: {calls[k]} calls, {launched} "
                                 f"launches")
    say(f"phase 3 kernel vs plain: equal in every case (6 configs + 8 "
        f"random wires; packed x 3 formats, planes, raw): cases "
        f"{json.dumps(calls)}, max |diff| {json.dumps(worst)}; planes "
        f"interleaved = SC16 words in all 14")
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
    from gps_sdr_sim_tpu_torch.models.scenario import (
        ScenarioConfig,
        build_scenario,
    )

    return build_scenario(ScenarioConfig(
        nav_file=str(ROOT / "data" / "brdc3540.14n"),
        motion_file=str(ROOT / "data" / "circle.csv"), duration=duration,
        samp_freq=2.6e6, data_format=fmt))


def golden_checksums() -> dict:
    path = ROOT / "tests" / "golden" / "bench_checksum.txt"
    rows = [ln.split() for ln in path.read_text().splitlines() if ln.strip()]
    return {int(r[0]): (int(r[1]), int(r[2])) for r in rows}


def canonical_runs(torch, scns: dict, label: str, timed_formats,
                   **run_kw) -> tuple[dict, dict]:
    """The canonical workload in every format through run_simulation(
    **run_kw), with every launch count set to 0 just before and read just
    after; then null-sink passes of `timed_formats`. Returns (launch
    counts, real-time factor by timed format)."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.quantize import wrap_int32
    from gps_sdr_sim_tpu_torch.runner import run_simulation

    goldens = golden_checksums()
    quiet = lambda s: None  # noqa: E731
    # Warm-up outside the counted run: pinned buffers, caches.
    run_simulation(canonical_scenario(16, 1.0), NullSink(), batch_epochs=100,
                   log=quiet, **run_kw)
    torch.cuda.synchronize()

    for k in synth.launch_counts:
        synth.launch_counts[k] = 0
    sinks, stats = {}, {}
    for fmt in FORMATS:
        sinks[fmt] = ChecksumSink(fmt)
        stats[fmt] = run_simulation(scns[fmt], sinks[fmt], batch_epochs=100,
                                    log=quiet, **run_kw)
    launches = dict(synth.launch_counts)

    rt = {}
    for fmt in FORMATS:
        scn, sink, st = scns[fmt], sinks[fmt], stats[fmt]
        got = (wrap_int32(sink.sum), sink.nonzero)
        if got != goldens[fmt]:
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


def bound_ms(in_bytes: int, out_bytes: int, instructions: int,
             samples: int, channels: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the channel loop's instructions for every needed (sample, channel)
    over the issue rate. Returns (ms, "bytes" or "operations")."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = instructions * samples * channels / ISSUE_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def phase_timing(torch, dev, sass_ops: dict) -> dict:
    """Kernel and plain-version ms of every mode on one 100-epoch 2.6 Msps
    batch, at the widths the main path gives each: the packed words over
    the active channels, the planes over all 16 wire channels (a 1x1
    mesh), the raw sums over one chan shard of 8 (a 2x2 mesh). Returns
    {report key: (ms, plain ms, bound ms, bound by)}."""
    from gps_sdr_sim_tpu_torch.ops import synth
    from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs

    scn = canonical_scenario(16)
    staged = synth.stage_epochs(
        plan_epochs(scn.segments[0], 0, 100, scn.delt), dev)
    n = scn.iq_buff_size
    wire, ca = staged.wire, staged.ca_words
    cases = [(f"synth_wire/{fmt}", wire, ca, staged.n_chan,
              lambda w, c, k, f=fmt: synth.synth_wire(w, c, k, n, f),
              lambda w, c, k, f=fmt: synth.synth_wire_ref(w, c, k, n, f))
             for fmt in FORMATS]
    cases.append(("synth_wire_planes", wire, ca, wire.shape[1],
                  lambda w, c, k: synth.synth_wire_planes(w, c, k, n),
                  lambda w, c, k: synth.synth_wire_planes_ref(w, c, k, n)))
    half = wire[:, :8].contiguous(), ca[:8].contiguous()
    cases.append(("synth_wire_raw", *half, 8,
                  lambda w, c, k: synth.synth_wire_raw(w, c, k, n),
                  lambda w, c, k: synth.synth_wire_raw_ref(w, c, k, n)))
    times = {}
    for key, w, c, k, kernel, plain in cases:
        got, want = kernel(w, c, k), plain(w, c, k)
        got, want = (got,) if torch.is_tensor(got) else got, \
            (want,) if torch.is_tensor(want) else want
        if not all(torch.equal(g, p) for g, p in zip(got, want)):
            raise AssertionError(f"{key} != plain version on the 100-epoch "
                                 f"batch")
        out_bytes = sum(g.numel() * g.element_size() for g in got)
        del got, want
        # Alternate kernel / plain / plain / kernel within one call.
        k1 = _time_cuda(torch, lambda: kernel(w, c, k), 20)
        p1 = _time_cuda(torch, lambda: plain(w, c, k), 3)
        p2 = _time_cuda(torch, lambda: plain(w, c, k), 3)
        k2 = _time_cuda(torch, lambda: kernel(w, c, k), 20)
        # The data needs the channels whose gain is not 0.
        active = int((w[:, :k, 11] != 0).any(dim=0).sum())
        in_bytes = w.numel() * 4 + c.numel() * 4 + 2 * 512 * 4
        bound, by = bound_ms(in_bytes, out_bytes, sass_ops[key],
                             w.shape[0] * n, active)
        times[key] = (min(k1, k2), min(p1, p2), bound, by)
        say(f"phase 7 timing {key}: {w.shape[0]} epochs x {n} samples x "
            f"{k} channels ({active} with gain): kernel {k1:.3f}/{k2:.3f} "
            f"ms ({w.shape[0] * n / min(k1, k2) / 1e6:.3f} Gsamples/s), "
            f"plain {p1:.3f}/{p2:.3f} ms, bound {bound:.3f} ms by {by} "
            f"({sass_ops[key]} instructions per (sample, channel), "
            f"{out_bytes} bytes out), kernel = plain bit for bit")
    return times


def phase_shard_files(torch, dev, duration: float = 30.0) -> None:
    """Shard files, concat, resume and --multihost against the single-file
    stream of the same scenario (SC16)."""
    from gps_sdr_sim_tpu_torch.parallel import (
        concat_shards,
        make_mesh,
        run_simulation_sharded,
    )
    from gps_sdr_sim_tpu_torch.runner import run_simulation

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
    scns = {fmt: canonical_scenario(fmt) for fmt in FORMATS}
    launches, rt = canonical_runs(torch, scns, "phase 6 canonical", FORMATS,
                                  impl="cuda", device=dev)
    times = phase_timing(torch, dev, sass_ops)
    from gps_sdr_sim_tpu_torch.parallel import make_mesh

    sharded = {}
    for label, mesh in (("1x1", make_mesh(1, 1, [dev])),
                        ("2x2", make_mesh(2, 2, [dev] * 4))):
        sharded[label] = canonical_runs(
            torch, scns, f"phase 8 cuda-sharded {label}", (16,),
            impl="cuda-sharded", mesh=mesh)
    phase_shard_files(torch, dev)

    # Each kernel's launches on the path that runs it.
    paths = {"synth_wire": launches["synth_wire"],
             "synth_wire_planes": sharded["1x1"][0]["synth_wire_planes"],
             "synth_wire_raw": sharded["2x2"][0]["synth_wire_raw"]}
    for name, count in paths.items():
        if count == 0:
            raise AssertionError(f"the main path launched no {name}")
    say(f"summary: real-time factor " + ", ".join(
        f"SC{f:02d} {rt[f]:.1f}x" for f in FORMATS) + "; cuda-sharded SC16 "
        + ", ".join(f"{label} {r[1][16]:.1f}x" for label, r in
                    sharded.items()) + f" on {card}")
    say(card)
    report = []
    for name, replaces in KERNELS.items():
        key = "synth_wire/16" if name == "synth_wire" else name
        ms, plain_ms, bound, by = times[key]
        row = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
               "replaces": replaces, "launches": paths[name],
               "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        if name == "synth_wire":
            for field, i in (("ms", 0), ("plain_ms", 1), ("bound_ms", 2)):
                row[f"{field}_by_format"] = {
                    str(f): times[f"synth_wire/{f}"][i] for f in FORMATS}
        report.append(row)
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
