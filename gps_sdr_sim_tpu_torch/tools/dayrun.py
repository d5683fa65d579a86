"""Full-day (86,400 s) static run, the reference's longest duration
(gpssim.h:24, duration check gpssim.c:1869-1874), end to end on the card.

Counterpart of the repository's root tools/dayrun.py. The run covers
863,999 epochs, 2.25e11 samples at 2.6 Msps, planned lazily
(models.scenario.build_scenario_streaming keeps host memory at one 30 s
segment), while the card synthesizes each batch with the hand-written
kernel (ops.synth.synth_staged_packed) and checksums it where it lies
(ops.quantize.checksum_packed). Sampled epoch blocks (deepcheck.pick_blocks)
are read back; their sha256 values can be held to a recorded run, and the
blocks to the C reference (phases oracle and diff).

Phases:
  synth   plan and synthesize the day on --device (cuda: the kernel; cpu:
          its plain version); writes the sampled blocks to --blocks-file
          and the stats to --json. --only-blocks LO,... synthesizes only
          the sampled blocks that start at those epochs (a spot check that
          a CPU can afford: one block of the day at 2.6 Msps is 20 epochs).
  oracle  stream the C reference's stdout through the same block sampler
          and save its blocks to --oracle-blocks-file.
  diff    compare two block files (synth's and oracle's, or any two of
          the same geometry) and merge the result into --json.

    python -m gps_sdr_sim_tpu_torch.tools.dayrun --phase synth
    python -m gps_sdr_sim_tpu_torch.tools.dayrun --phase oracle
    python -m gps_sdr_sim_tpu_torch.tools.dayrun --phase diff

The pipeline per batch: a producer thread plans (plan_epochs, pad_epochs)
and uploads the wire (ops.synth.stage_epochs) on the stream the main
thread launches on, feeding a queue of 3; the main thread launches the
kernel and the checksum, and starts a non-blocking copy of each sampled
block's rows into pinned host memory, which a collector thread turns into
bytes once the copy's event has fired. The checksums are drained in one
transfer every --drain-epochs epochs, which bounds the batches in flight
and gives one row of the throughput timeline.

What the JAX tool has and this one has not:
  - the kernel-signature warm-up and its .jax_cache signature file: they
    served Mosaic's compile per (channel count, premult); the CUDA kernel
    takes the channel count at run time, so the kernel is built and
    launched once before the timed window (warm_s);
  - _fetch_with_retry and its recompute closures: a CUDA error is sticky
    for the context, so a retry inside the process cannot recover, and a
    failed batch fails the run;
  - premult_ok / int_step: lowering knobs of the TPU kernel.
--json, --blocks-file and --oracle-blocks-file write where they are told;
their defaults lie under build/ (the JAX tool's default --json is a file
at the repository root).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import hashlib
import json
import pathlib
import queue
import resource
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.models.scenario import build_scenario_streaming
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.plan import pad_epochs, plan_epochs
from gps_sdr_sim_tpu_torch.ops.quantize import (
    checksum_packed,
    words_to_bytes,
    wrap_int32,
)
from gps_sdr_sim_tpu_torch.runner import (
    check_epoch_count,
    iter_segment_batches,
)
from gps_sdr_sim_tpu_torch.testing import ROOT
from gps_sdr_sim_tpu_torch.tools.deepcheck import (
    REF,
    ReferenceMissing,
    build_oracle,
    oracle_command,
    pick_blocks,
    static_config,
    stream_sample,
)

BUILD = ROOT / "build"
# Epochs in flight between the producer and the main thread.
_QUEUE_DEPTH = 3


@dataclass
class DayRun:
    """What synth_day returns: the stats (the JSON the synth phase writes),
    the sampled blocks' bytes by first epoch, and with keep_block_batches
    the staged batches that hold a sampled block, as (staged, first output
    epoch, valid epochs)."""
    stats: dict
    blocks: dict
    block_batches: list = field(default_factory=list)


def block_slices(blocks, out_lo: int, out_hi: int):
    """(block start, first row, end row) of each sampled block's part in a
    batch of output epochs [out_lo, out_hi); rows count from out_lo."""
    return [(blo, max(blo, out_lo) - out_lo, min(bhi, out_hi) - out_lo)
            for blo, bhi in blocks if max(blo, out_lo) < min(bhi, out_hi)]


def _merge(ranges):
    """Sorted union of [lo, hi) epoch ranges (sampled blocks may
    overlap)."""
    out = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(r) for r in out]


def _iter_batches(segments, ranges, batch_epochs: int):
    """iter_segment_batches over each of the disjoint sorted `ranges`,
    stopping the segment stream after the last range's end."""
    last = ranges[-1][1]
    for seg in segments:
        if seg.first_epoch - 1 >= last:
            return
        for lo, hi in ranges:
            yield from iter_segment_batches([seg], lo, hi, batch_epochs)


def synth_day(cfg, batch_epochs: int = 300, drain_epochs: int = 2000,
              block_epochs: int = 20, filler_blocks: int = 8,
              device="cuda", only_blocks=None,
              keep_block_batches: bool = False, log=None) -> DayRun:
    """The synth phase: plan and synthesize scenario `cfg` (a static
    ScenarioConfig; deepcheck.static_config) on `device`, the kernel on a
    card and its plain version on the CPU. only_blocks: first epochs of
    the sampled blocks to synthesize instead of the whole run. The nav
    mask-table switch (GPS_SDR_SIM_NAV_GATHER) is read once, at the start.
    On a card the kernel is launched once more, on a zero wire, to build
    and warm it before the timed window. Raises ValueError for an epoch
    count below 1 or an unknown block, RuntimeError for a CUDA device that
    is not available; an exception in the producer or collector thread is
    raised here."""
    for name, v in (("batch_epochs", batch_epochs),
                    ("drain_epochs", drain_epochs),
                    ("block_epochs", block_epochs)):
        check_epoch_count(v, name)
    if log is None:
        def log(line: str) -> None:
            print(line, end="", file=sys.stderr, flush=True)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"CUDA device '{device}' is not available")
    fmt = cfg.data_format
    nav_gather = synth.nav_gather_enabled()

    t0 = time.time()
    scn, engine = build_scenario_streaming(cfg)
    n = scn.iq_buff_size
    B = batch_epochs
    total = scn.n_output_epochs
    blocks = pick_blocks(scn, block_epochs, filler_blocks)
    if only_blocks is None:
        ranges = [(0, total)]
    else:
        starts = {lo for lo, _ in blocks}
        unknown = sorted(set(only_blocks) - starts)
        if unknown:
            raise ValueError(f"no sampled block starts at epochs {unknown}; "
                             f"the blocks start at {sorted(starts)}")
        blocks = [b for b in blocks if b[0] in set(only_blocks)]
        ranges = _merge(blocks)
    log(f"day run: {total} epochs, {scn.total_samples:,} samples, "
        f"streaming-planned; sampling {len(blocks)} blocks\n")
    build_s = time.time() - t0

    # Build and launch the kernel once, outside the timed window.
    t_warm = time.time()
    if cuda:
        with torch.cuda.device(device):
            zeros = torch.zeros((1, 1, 12), dtype=torch.int32, device=device)
            ca = torch.zeros((1, 32), dtype=torch.int32, device=device)
            w = synth.synth_wire(zeros, ca, 1, n, fmt, nav_gather)
            checksum_packed(w, 1, n, fmt)[0].item()
        stream = torch.cuda.current_stream(device)
    warm_s = time.time() - t_warm
    rss_warm_mb = _peak_rss_mb()

    plan_s = 0.0
    stop = threading.Event()
    q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
    plan_err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        nonlocal plan_s
        try:
            with contextlib.ExitStack() as ctx:
                if cuda:  # the main thread's device and stream, explicitly
                    ctx.enter_context(torch.cuda.device(device))
                    ctx.enter_context(torch.cuda.stream(stream))
                it = _iter_batches(engine.iter_run(), ranges, B)
                while True:
                    t = time.time()  # segment planning happens in next()
                    item = next(it, None)
                    if item is None:
                        plan_s += time.time() - t
                        break
                    seg, e0, e1 = item
                    eb = plan_epochs(seg, e0, e1, scn.delt)
                    # The whole day pads each batch to B, as the runner
                    # does; a spot check synthesizes just its blocks.
                    if only_blocks is None:
                        eb = pad_epochs(eb, B)
                    staged = synth.stage_epochs(eb, device)
                    plan_s += time.time() - t
                    if not put((staged, item)):
                        return
        except BaseException as ex:  # raised on the main thread
            plan_err.append(ex)
        finally:
            put(None)

    fetch_q: queue.Queue = queue.Queue()
    fetched: dict = {}
    fetch_err: list = []

    def collector():
        try:
            while True:
                item = fetch_q.get()
                if item is None:
                    return
                seqno, blo, host, done = item
                if done is not None:
                    done.synchronize()
                by = words_to_bytes(host.numpy(), n, fmt)
                fetched[seqno] = (blo, bytes(np.ascontiguousarray(by)))
        except BaseException as ex:
            fetch_err.append(ex)

    sums: list = []
    nz_min = 1 << 62
    batches = epochs_done = 0
    timeline = []  # one row per checksum drain: interval throughput
    pending = []   # (sum, nonzero) device scalars, drained in bulk
    kernel_events = []
    block_batches = []
    drain_every = max(1, drain_epochs // B)

    def drain():
        nonlocal nz_min
        drained = torch.stack([torch.stack(p) for p in pending]).cpu()
        sums.extend(int(v) for v in drained[:, 0])
        nz_min = min(nz_min, int(drained[:, 1].min()))
        pending.clear()

    t_run = time.time()
    t_last, e_last = t_run, 0
    threads = [threading.Thread(target=producer, daemon=True),
               threading.Thread(target=collector, daemon=True)]
    for t in threads:
        t.start()
    fetch_seq = 0
    try:
        with contextlib.ExitStack() as ctx:
            if cuda:
                ctx.enter_context(torch.cuda.device(device))
            while True:
                got = q.get()
                if got is None:
                    if plan_err:
                        raise plan_err[0]
                    break
                staged, (seg, e0, e1) = got
                words = synth.synth_staged_packed(
                    staged, n, fmt, plain=not cuda, nav_gather=nav_gather,
                    timing=kernel_events)
                pending.append(checksum_packed(words, e1 - e0, n, fmt))
                out_lo = seg.first_epoch - 1 + e0
                out_hi = out_lo + (e1 - e0)
                parts = block_slices(blocks, out_lo, out_hi)
                for blo, r0, r1 in parts:
                    # Copy just the block's rows: the batch itself is
                    # released below and its memory reused in stream order.
                    sl = words[r0:r1]
                    if cuda:
                        host = torch.empty(sl.shape, dtype=sl.dtype,
                                           pin_memory=True)
                        host.copy_(sl, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(stream)
                    else:
                        host, done = sl.clone(), None
                    del sl  # the view would keep the batch alive
                    fetch_q.put((fetch_seq, blo, host, done))
                    fetch_seq += 1
                if parts and keep_block_batches:
                    block_batches.append((staged, out_lo, e1 - e0))
                del words
                batches += 1
                epochs_done += e1 - e0
                if batches % drain_every == 0:
                    drain()
                    now = time.time()
                    timeline.append({
                        "t_s": now - t_run,
                        "epochs_done": out_hi,
                        "interval_gsps": (epochs_done - e_last) * n
                        / max(now - t_last, 1e-9) / 1e9})
                    t_last, e_last = now, epochs_done
                    rate = epochs_done * n / (now - t_run)
                    log(f"\r{out_hi / total * 100:5.1f}%  "
                        f"{rate / 1e9:.2f} Gsamples/s  plan {plan_s:.0f} s")
    finally:
        stop.set()
        fetch_q.put(None)
        threads[1].join()
    if fetch_err:
        raise fetch_err[0]
    if pending:
        drain()
    wall = time.time() - t_run
    log("\n")

    sampled: dict = {}
    for seqno in sorted(fetched):
        blo, by = fetched[seqno]
        sampled.setdefault(blo, []).append(by)
    sampled = {lo: b"".join(parts) for lo, parts in sampled.items()}
    kernel_s = (sum(a.elapsed_time(b) for a, b in kernel_events) / 1e3
                if cuda else None)
    simulated_s = cfg.duration if only_blocks is None else epochs_done * 0.1
    rates = sorted(r["interval_gsps"] for r in timeline) or [0.0]
    stats = {
        "metric": "day_run_86400s",
        "started_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "duration_s": cfg.duration, "samp_freq": scn.samp_freq,
        "fmt": fmt, "epochs": total, "iq_buff_size": n,
        "total_samples": scn.total_samples,
        "device": str(device),
        "synthesis": "cuda kernel" if cuda else "plain version",
        "card": _card() if cuda else None,
        "nav_gather": nav_gather,
        "only_blocks": None if only_blocks is None else sorted(only_blocks),
        "epochs_synthesized": epochs_done,
        "batches": batches,
        "wall_s": wall,
        "build_s": build_s,
        "warm_s": warm_s,
        "batch_epochs": B,
        "drain_epochs": drain_epochs,
        "plan_s": plan_s,
        "plan_overlapped": True,  # planner thread; plan_s hides in waits
        "plan_epochs_per_s": epochs_done / max(plan_s, 1e-9),
        "kernel_s": kernel_s,
        "kernel_busy_share": None if kernel_s is None else kernel_s / wall,
        "realtime_factor": simulated_s / wall,
        "samples_per_s": epochs_done * n / wall / 1e9,
        "peak_rss_mb": _peak_rss_mb(),
        "peak_rss_before_run_mb": rss_warm_mb,
        "checksum_wrapped_int32": wrap_int32(sum(sums)),
        "min_batch_nonzero": nz_min,
        "all_batches_nonzero": nz_min > 0,
        "sampled_blocks": [[lo, hi] for lo, hi in blocks],
        "block_sha256": {str(lo): hashlib.sha256(b).hexdigest()
                         for lo, b in sampled.items()},
        "interval_gsps_min": rates[0],
        "interval_gsps_median": rates[len(rates) // 2],
        "interval_gsps_max": rates[-1],
        "throughput_timeline": timeline,
        "oracle": "pending (run --phase oracle)",
    }
    return DayRun(stats, sampled, block_batches)


def _peak_rss_mb() -> float:
    """The process's peak resident set so far, in MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _card() -> str:
    from gps_sdr_sim_tpu_torch.tools.card import card_line

    return card_line()


def _config(ns):
    return static_config(ns.samp_freq, ns.duration, ns.fmt)


def _write(path, text: str) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def save_blocks(path, blocks: dict, **extra) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **extra, **{
        f"b{lo}": np.frombuffer(b, np.uint8) for lo, b in blocks.items()})


def phase_synth(ns) -> int:
    only = ([int(v) for v in ns.only_blocks.split(",")]
            if ns.only_blocks else None)
    if torch.device(ns.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"ERROR: CUDA device '{ns.device}' is not available; --device "
              f"cpu runs the plain version", file=sys.stderr)
        return 1
    try:
        run = synth_day(_config(ns), ns.batch_epochs, ns.drain_epochs,
                        ns.block_epochs, ns.filler_blocks, ns.device, only)
    except ValueError as e:  # a count below 1, an unknown block
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    stats = dict(run.stats, blocks_file=str(ns.blocks_file))
    save_blocks(ns.blocks_file, run.blocks)
    _write(ns.json, json.dumps(stats, indent=1))
    print(json.dumps({k: v for k, v in stats.items()
                      if k not in ("sampled_blocks", "throughput_timeline")}))
    return 0


def _blocks_for(ns):
    """The deterministic sampled-block list and the scenario, host only:
    every phase derives the same list from the configuration, so the
    oracle can stream while the synth phase runs."""
    scn, _engine = build_scenario_streaming(_config(ns))
    return scn, pick_blocks(scn, ns.block_epochs, ns.filler_blocks)


def phase_oracle(ns) -> int:
    with tempfile.TemporaryDirectory() as td:
        try:
            oracle = build_oracle(pathlib.Path(td), ns.reference)
        except ReferenceMissing as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        scn, blocks = _blocks_for(ns)
        bpe = synth.packed_bytes(scn.iq_buff_size, ns.fmt)
        ranges_bytes = [(lo * bpe, hi * bpe) for lo, hi in blocks]
        t0 = time.time()
        kept = stream_sample(oracle_command(oracle, ns.duration, ns.samp_freq,
                                            ns.fmt),
                             ranges_bytes, scn.n_output_epochs * bpe)
        oracle_s = time.time() - t0
    print(f"oracle run: {oracle_s:.0f} s", file=sys.stderr)
    save_blocks(ns.oracle_blocks_file,
                {lo: bytes(kept[blo]) for (lo, _hi), (blo, _bhi)
                 in zip(blocks, ranges_bytes)},
                oracle_wall_s=np.float64(oracle_s))
    return 0


def diff_blocks(ours, ref, blocks, fmt: int):
    """Compare two block files' contents (mappings of "b<lo>" to uint8
    arrays) over `blocks`. Returns (pass, worst, per-block report).

    A chip-edge straddle: the planner computes the float64 code phase in
    closed form while the C hot loop accumulates it per sample
    (gpssim.c:2190-2264), so a sample within ~1 ULP of a C/A chip boundary
    can pick the opposite chip for one channel at one sample: a large
    isolated |delta| on that sample's I and Q only. An event is a straddle
    iff all its deltas above 8 lie in one complex sample and both
    neighbouring samples match within 8; anything else above 8 is a hard
    mismatch."""
    view = {16: np.int16, 8: np.int8, 1: np.uint8}[fmt]
    report = []
    worst = {"frac": 0.0, "max": 0, "big": 0, "straddles": 0, "vals": 0}
    for lo, hi in blocks:
        a = ours[f"b{lo}"].view(view).astype(np.int32)
        b = ref[f"b{lo}"].view(view).astype(np.int32)
        if a.size != b.size:
            raise ValueError(f"block [{lo}, {hi}) holds {a.size} and "
                             f"{b.size} values in the two files")
        d = np.abs(a - b)
        frac = float(np.count_nonzero(d) / d.size)
        big_idx = np.where(d > 8)[0]
        straddle, hard = 0, 0
        for s in sorted({int(i) // 2 for i in big_idx}):
            ev = d[max(0, 2 * s - 2):2 * s + 4]
            if ev[:2].max(initial=0) <= 8 and ev[4:].max(initial=0) <= 8 \
                    and ev.size >= 4:
                straddle += 1
            else:
                hard += 1
        entry = {"epochs": [lo, hi], "t_start_s": round(lo * 0.1, 1),
                 "mismatch_fraction": round(frac, 8),
                 "max_delta": int(d.max(initial=0)),
                 "chip_straddles": straddle, "hard_mismatches": hard}
        report.append(entry)
        worst["frac"] = max(worst["frac"], frac)
        worst["max"] = max(worst["max"], entry["max_delta"])
        worst["straddles"] += straddle
        worst["big"] += hard
        worst["vals"] += d.size
    # Pass: NCO-noise fraction within budget, no hard mismatch, straddles
    # below 1e-6 of the compared complex samples (a cluster or a drift
    # fails the isolation test above).
    ok = (worst["frac"] <= 1e-4 and worst["big"] == 0
          and worst["straddles"] <= max(2, int(worst["vals"] / 2e6)))
    return ok, worst, report


def phase_diff(ns) -> int:
    _scn, blocks = _blocks_for(ns)
    json_path = pathlib.Path(ns.json)
    stats = json.loads(json_path.read_text()) if json_path.is_file() else {}
    if "sampled_blocks" in stats and \
            [list(b) for b in blocks] != stats["sampled_blocks"]:
        raise ValueError(f"{json_path} was synthesized with a different "
                         f"block geometry")
    ours = np.load(ns.blocks_file)
    ref = np.load(ns.oracle_blocks_file)
    ok, worst, report = diff_blocks(ours, ref, blocks, ns.fmt)
    for entry in report:
        print(json.dumps(entry), file=sys.stderr)
    stats["oracle"] = {
        "oracle_wall_s": (float(ref["oracle_wall_s"])
                          if "oracle_wall_s" in ref.files else None),
        "oracle_blocks_file": str(ns.oracle_blocks_file),
        "oracle_block_sha256": {
            str(lo): hashlib.sha256(ref[f"b{lo}"].tobytes()).hexdigest()
            for lo, _hi in blocks},
        "worst_mismatch_fraction": worst["frac"],
        "worst_max_delta": worst["max"],
        "chip_straddles": worst["straddles"],
        "hard_mismatches": worst["big"],
        "compared_values": worst["vals"],
        "pass": ok, "detail": report,
    }
    _write(json_path, json.dumps(stats, indent=1))
    print(json.dumps({"oracle_pass": ok, **{k: v for k, v in
                      stats["oracle"].items() if k != "detail"}}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.dayrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="synth",
                    choices=("synth", "oracle", "diff"))
    ap.add_argument("--duration", type=float, default=86400.0)
    ap.add_argument("--samp-freq", type=float, default=2.6e6)
    ap.add_argument("--fmt", type=int, default=16, choices=(16, 8, 1))
    # 300-epoch batches align with the engine's 30 s segments (boundaries
    # every 300 epochs), so only the last batch (299 epochs) is padded.
    # The drain cadence is in epochs, so the batches in flight (about
    # drain_epochs * n * 4 bytes of output) and the timeline's grain do
    # not depend on the batch size.
    ap.add_argument("--batch-epochs", type=int, default=300)
    ap.add_argument("--drain-epochs", type=int, default=2000)
    ap.add_argument("--block-epochs", type=int, default=20)
    ap.add_argument("--filler-blocks", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): the kernel; cpu: its plain "
                         "version")
    ap.add_argument("--only-blocks", default="", metavar="LO[,LO...]",
                    help="synthesize only the sampled blocks starting at "
                         "these epochs")
    ap.add_argument("--reference", default=str(REF),
                    help="directory of the C reference's gpssim.c/.h "
                         "(phase oracle)")
    ap.add_argument("--json", default=str(BUILD / "dayrun.json"))
    ap.add_argument("--blocks-file",
                    default=str(BUILD / "dayrun_blocks.npz"))
    ap.add_argument("--oracle-blocks-file",
                    default=str(BUILD / "dayrun_oracle_blocks.npz"))
    ns = ap.parse_args(argv)
    if (err := synth.refuse_samp_freq(ns.samp_freq)) is not None:
        print(err, file=sys.stderr)
        return 1
    # synth_day checks the synth phase's counts; the others sample blocks.
    if ns.phase != "synth" and ns.block_epochs < 1:
        print("ERROR: --block-epochs must be at least 1.", file=sys.stderr)
        return 1
    return {"synth": phase_synth, "oracle": phase_oracle,
            "diff": phase_diff}[ns.phase](ns)


if __name__ == "__main__":
    raise SystemExit(main())
