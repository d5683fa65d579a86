"""Cost attribution for the synthesis kernel (csrc/synth.cu).

Counterpart of tools/profile_kernel.py. The card's machine runs no
profiler with a per-instruction view (ncu, nsys and compute-sanitizer do
not run there; cuobjdump and -Xptxas -v do), so attribution is measured
the direct way, as on the TPU: the production packed kernel is timed
against variants with exactly one cost centre replaced by a stand-in of
the same shape (csrc/synth_profile.cu: synth_block's ABLATE mask, the
Pallas kernel's `ablate` argument), so the time a variant saves is that
centre's share of the kernel's time.

Method: every variant is first held to its plain version on the batch
(ops.synth.synth_wire_ref for the production kernels, schedule_words with
the ablation set for the others; a mismatch exits 1 before any timing),
then all are timed in turns in one process by
tools/ab_kernel.interleaved_times: CUDA events, best of a burst of
passes, the burst order alternating from rep to rep, a variant's time its
best rep. The full kernel is also timed at B/4, B and 2B epochs, and a
line through those times gives the kernel's ns per (sample, channel with
gain) and the fixed ms of a pass.

Centres (the packed walk kernel, SC16):
  trig_gather  the per-(sample, channel) shared load of the +-(cos, sin)
               pair (stand-in: the table index itself)
  ca_gather    the per-(sample, channel) sign-word load and funnel shift
               (stand-in: bit 0 of the chip count)
  nav_walk     the nav rule, which this kernel runs in the block prologue
               once per (block, channel, code period), not per sample
               (stand-in: every nav bit 0)
  alu          everything else: the no_gathers row
  epilogue     the SC08 and SC01 packing, from the full_sc08 / full_sc01
               times against full
A delta below the full kernel's rep-to-rep spread is reported as null,
never as a number, and so is the gather additivity check (the two single
gather deltas over the joint one, near 1 when the deltas are real) when
the joint or the larger single delta is below it.

Instruction equivalents: each time is priced with the alu SASS
instructions per second that tools/vpu_peak measures in the same process
(the two-point peak of its alu case), in place of the TPU's
VPU_PEAK.json: t * rate / (sample, channel) pairs.

Usage: python -m gps_sdr_sim_tpu_torch.tools.profile_kernel
           [--batch-epochs 400] [--passes 5] [--reps 4] [--json FILE]
           [--samp-freq 2.6e6] [--cpu]
Scenario: static Tokyo with brdc3540.14n at 2.6 Msps (13 channels with
gain; 400 epochs are 104 M samples, 416 MB of SC16 words), every epoch of
a batch planned, across the scenario's 30 s segments (real_epochs).
Without --cpu it needs a card and does not fall back; --cpu runs the plain
versions on the CPU to smoke-test the plumbing, and its times say nothing
about the card. Prints ONE JSON line (all but `rows`) on stdout; --json
FILE gets all of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.constants import SUBBLOCK
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth, synth_cuda
from gps_sdr_sim_tpu_torch.ops.plan import plan_epochs
from gps_sdr_sim_tpu_torch.testing import NAV, TOKYO
from gps_sdr_sim_tpu_torch.tools.ab_kernel import interleaved_times

VARIANTS = {
    # name -> (ablation set, fmt); the full* rows are production kernels
    "full": ((), 16),
    "no_trig_gather": (("no_trig_gather",), 16),
    "no_ca_gather": (("no_ca_gather",), 16),
    "no_nav_walk": (("no_nav_walk",), 16),
    "no_gathers": (("no_trig_gather", "no_ca_gather"), 16),
    "full_sc08": ((), 8),
    "full_sc01": ((), 1),
}
SAMP_FREQ = 2.6e6

# Launches of the ablated kernels, counted where the wrapper launches them.
launch_counts = {"synth_wire_ablated": 0}


def synth_wire_ablated(wire: torch.Tensor, ca_words: torch.Tensor,
                       n_chan: int, n_out: int, fmt: int,
                       ablate) -> torch.Tensor:
    """[B, C, 12] wire -> [B, words_per_epoch(n_out, fmt)] int32 words of
    the ablated packed walk kernel of set `ablate`
    (synth_cuda.ABLATION_SETS): wrong by design. CUDA tensors go through
    csrc/synth_profile.cu (a build or launch failure raises); CPU tensors
    through the plain version, synth.schedule_words."""
    synth_cuda.ablate_mask(ablate)
    if fmt not in synth.PACK_DIV:
        raise ValueError(f"Invalid I/Q data format: {fmt}")
    synth._check(wire, ca_words, n_chan, n_out)
    if wire.device.type == "cpu":
        return synth.schedule_words(wire, ca_words, n_chan, n_out, fmt,
                                    ablate)
    out = torch.empty((wire.shape[0], synth.words_per_epoch(n_out, fmt)),
                      dtype=torch.int32, device=wire.device)
    synth_cuda.launch_ablated(wire, ca_words, synth.trig_table(wire.device),
                              out, n_chan, -(-n_out // SUBBLOCK), fmt,
                              ablate)
    launch_counts["synth_wire_ablated"] += 1
    return out


def variant(name: str, staged: synth.Staged, n_out: int):
    """(kernel, plain version) of variant `name` on a staged batch, each a
    callable returning the words."""
    ablate, fmt = VARIANTS[name]
    args = (staged.wire, staged.ca_words, staged.n_chan, n_out, fmt)
    if not ablate:
        return (lambda: synth.synth_wire(*args),
                lambda: synth.synth_wire_ref(*args))
    return (lambda: synth_wire_ablated(*args, ablate),
            lambda: synth.schedule_words(*args, ablate))


def pairs_with_gain(staged: synth.Staged) -> int:
    """(epoch, channel) pairs of the staged batch whose gain is not 0."""
    return int((staged.wire[:, :staged.n_chan, 11] != 0).sum())


def breakdown(best: dict, full_reps: list, chan_samples: int,
              samples: int, alu_rate=None) -> tuple[dict, dict]:
    """(breakdown, epilogue) of the best times {variant: s} of VARIANTS,
    in the keys of PROFILE_r05.json. The noise floor is the full kernel's
    rep-to-rep spread (max - min of full_reps); a centre's delta below it
    is None, and so are the shares and the additivity check when the joint
    gather delta or the larger single one is below it. alu_rate: SASS
    instructions per s that price each time as instruction equivalents
    per (sample, channel), or None."""
    t_full = best["full"]
    noise = max(full_reps) - min(full_reps)
    t_alu = best["no_gathers"]
    deltas = {c: t_full - best[f"no_{c}"]
              for c in ("trig_gather", "ca_gather", "nav_walk")}
    vacuous = bool(t_full - t_alu < noise
                   or max(deltas["trig_gather"], deltas["ca_gather"]) < noise)
    # The gathers' deltas follow the joint rule too, as on the TPU.
    real = {c: None if d < noise or (vacuous and c != "nav_walk") else d
            for c, d in deltas.items()}

    def ns(t, per=chan_samples):
        return None if t is None else t / per * 1e9

    def share(t):
        return None if vacuous else t / t_full

    gathers = deltas["trig_gather"] + deltas["ca_gather"]
    out = {
        "trig_gather_ns_per_chan_sample": ns(real["trig_gather"]),
        "ca_gather_ns_per_chan_sample": ns(real["ca_gather"]),
        "nav_walk_ns_per_chan_sample": ns(real["nav_walk"]),
        "alu_ns_per_chan_sample": ns(t_alu),
        "full_ns_per_chan_sample": ns(t_full),
        "gather_share_of_kernel": share(gathers),
        "gather_additivity_check": (
            None if vacuous else gathers / max(t_full - t_alu, 1e-12)),
        "noise_floor_ns_per_chan_sample": ns(noise),
        "additivity_vacuous_below_noise": vacuous,
        "gathers_total_ns_per_chan_sample": (
            None if vacuous else ns(t_full - t_alu)),
        "gathers_total_share_of_kernel": share(t_full - t_alu),
    }
    if alu_rate:
        def equiv(t):
            return None if t is None else t / chan_samples * alu_rate
        out.update({
            "alu_equiv_ops_per_chan_sample": equiv(t_alu),
            "full_equiv_ops_per_chan_sample": equiv(t_full),
            "trig_gather_equiv_alu_ops": equiv(real["trig_gather"]),
            "ca_gather_equiv_alu_ops": equiv(real["ca_gather"]),
            "nav_walk_equiv_alu_ops": equiv(real["nav_walk"]),
            "equiv_unit": "SASS instructions at vpu_peak's measured alu "
                          "rate, per (sample, channel with gain)",
        })
    epilogue = {}
    for fmt in ("sc08", "sc01"):
        d = best[f"full_{fmt}"] - t_full
        epilogue[f"{fmt}_extra_ns_per_sample"] = (
            None if abs(d) < noise else ns(d, samples))
    return out, epilogue


def real_epochs(scn, epochs: int):
    """The scenario's first `epochs` epochs as one EpochBatch, every one
    planned (none padded), across its 30 s segments. The kernel takes one
    C/A table a batch, so the segments must give their channels the same
    satellites, as a static scenario's do."""
    parts, left = [], epochs
    for seg in scn.segments:
        if left == 0:
            break
        parts.append(plan_epochs(seg, 0, min(left, seg.n_epochs), scn.delt))
        left -= parts[-1].gain.shape[0]
    if left:
        raise ValueError(f"the scenario holds fewer than {epochs} epochs")
    first = parts[0]
    if any(p.n_chan != first.n_chan
           or not np.array_equal(p.ca_words, first.ca_words)
           for p in parts[1:]):
        raise ValueError("the segments give the channels other satellites")
    return dataclasses.replace(first, **{
        f.name: np.concatenate([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first)
        if f.name not in ("ca_words", "n_chan")})


def staged_epochs(scn, epochs: int, device) -> synth.Staged:
    return synth.stage_epochs(real_epochs(scn, epochs), device)


def profile(batch_epochs: int = 400, passes: int = 5, reps: int = 4,
            device="cuda", samp_freq: float = SAMP_FREQ) -> dict:
    """The attribution on `device` (the plain versions on the CPU). Raises
    AssertionError if a variant's words differ from its plain version."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    B = batch_epochs
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.1 * (2 * B + 2),
        samp_freq=samp_freq))
    n = scn.iq_buff_size
    staged = staged_epochs(scn, B, device)

    peak = None
    if cuda:
        from gps_sdr_sim_tpu_torch.tools import vpu_peak

        res = vpu_peak.measure(device, tiles=2048, rounds=512, reps=3)
        peak = {k: res[k] for k in (
            "peak_sass_per_s", "peak_source_ops_per_s",
            "gather_cost_alu_ops", "imul_cost_alu_ops",
            "f32_roundtrip_cost_alu_ops", "card")}

    fns = {}
    for name in VARIANTS:
        kernel, plain = variant(name, staged, n)
        got, want = kernel(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain version on the "
                                 f"{B}-epoch batch")
        print(f"{name}: kernel = plain version ({got.numel()} words)",
              file=sys.stderr)
        del got, want
        fns[name] = kernel

    sizes = sorted({max(B // 4, 1), B, 2 * B})
    sized_staged = {e: staged if e == B else staged_epochs(scn, e, device)
                    for e in sizes}
    sized = {e: variant("full", s, n)[0] for e, s in sized_staged.items()}
    for fn in sized.values():
        fn()
    size_reps = interleaved_times(sized, passes, reps, device)
    xs = np.array([pairs_with_gain(sized_staged[e]) * n for e in sizes],
                  dtype=np.float64)
    ys = np.array([min(size_reps[e]) for e in sizes])
    slope, intercept = np.polyfit(xs, ys, 1)
    slope_ns = float(slope) * 1e9
    print(f"slope fit: {slope_ns:.5f} ns per (sample, channel) + "
          f"{float(intercept) * 1e3:.4f} ms fixed per pass", file=sys.stderr)

    times = interleaved_times(fns, passes, reps, device)
    samples = B * n
    pairs = pairs_with_gain(staged)
    cs = pairs * n
    rows = {name: {
        "variant": name, "ablate": list(VARIANTS[name][0]),
        "fmt": VARIANTS[name][1], "best_s": min(t), "reps_s": t,
        "epochs": B, "samples": samples, "n_chan": staged.n_chan,
        "chan_samples": cs, "chan_samples_per_s": cs / min(t),
        "samples_per_s": samples / min(t),
    } for name, t in times.items()}
    alu_rate = peak["peak_sass_per_s"] if peak else None
    best = {name: r["best_s"] for name, r in rows.items()}
    brk, epilogue = breakdown(best, times["full"], cs, samples, alu_rate)

    overhead = {
        "batch_sizes_epochs": sizes,
        "best_s_per_size": {str(e): min(size_reps[e]) for e in sizes},
        "kernel_slope_ns_per_chan_sample": slope_ns,
        "fixed_overhead_ms_per_pass": float(intercept) * 1e3,
        "note": ("CUDA events around each launch: the fixed part is what "
                 "a launch costs beyond its (sample, channel) pairs, the "
                 "slope the kernel's cost per pair. Ablation deltas "
                 "subtract equal fixed parts."),
    }
    if alu_rate:
        overhead["kernel_slope_equiv_alu_ops"] = slope_ns * 1e-9 * alu_rate
    return {
        "metric": "kernel_cost_attribution",
        "overhead_separation": overhead,
        "method": ("interleaved same-process ablation: the production "
                   "kernel and its ablated instantiations "
                   "(csrc/synth_profile.cu), each first held to its plain "
                   "version, timed in turns by CUDA events "
                   "(ab_kernel.interleaved_times), best of passes x reps"),
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": peak["card"] if peak else None,
        "rows": rows,
        "breakdown": brk,
        "epilogue": epilogue,
        "vpu_peak_ref": peak,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.profile_kernel")
    ap.add_argument("--batch-epochs", type=int, default=400)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--reps", type=int, default=4,
                    help="use an even count: the burst order alternates")
    ap.add_argument("--samp-freq", type=float, default=SAMP_FREQ)
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU (plumbing only)")
    ap.add_argument("--json", default="", help="write all of it here")
    ns = ap.parse_args(argv)
    if (err := synth.refuse_samp_freq(ns.samp_freq)) is not None:
        print(err, file=sys.stderr)
        return 1
    if ns.batch_epochs < 1 or ns.passes < 1 or ns.reps < 1:
        print("ERROR: --batch-epochs, --passes and --reps must be at least "
              "1.", file=sys.stderr)
        return 1
    if not ns.cpu and not torch.cuda.is_available():
        print("ERROR: no CUDA device (use --cpu to smoke-test the plumbing)",
              file=sys.stderr)
        return 1
    try:
        out = profile(ns.batch_epochs, ns.passes, ns.reps,
                      "cpu" if ns.cpu else "cuda", ns.samp_freq)
    except AssertionError as e:
        print(f"MISMATCH: {e}", file=sys.stderr)
        return 1
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
