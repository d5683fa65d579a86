"""Interleaved same-process A/B of two variants of the synthesis kernel.

Counterpart of tools/ab_kernel.py. It times two variants of the packed-word
kernel (ops.synth.synth_wire) in turns in one process, on one staged batch
of the same scenario (Tokyo static, 2.6 Msps, brdc3540.14n), after first
checking that they write identical words: a mismatch exits 1 before any
timing. Each rep times a burst of passes of each variant, best of the
passes, and the burst order alternates from rep to rep so that a drifting
clock favours neither; a variant's time is its best rep. Passes are timed
with CUDA events. compare() is that gate and loop for any two callables,
and interleaved_times() the loop alone (tools/profile_kernel.py times its
ablated variants with it, after a gate of its own, since they differ from
one another by design).

Variants:
  default     the window walk, as the main path runs it
  nav_gather  the nav mask-table variant (GPS_SDR_SIM_NAV_GATHER=1)
The JAX harness's other variants (int_m, int_nav, f32_nav, int_all, mix,
wrap, tree) are lowering choices of the TPU kernel and have no counterpart
here; they are refused by name.

Usage: python -m gps_sdr_sim_tpu_torch.tools.ab_kernel --b nav_gather
           [--a default] [--fmt 16|8|1] [--batch-epochs 400] [--passes 7]
           [--reps 4] [--json FILE] [--cpu]
--cpu runs the plain versions on the CPU, to smoke-test the plumbing; its
times say nothing about the card. Prints one JSON line with b_over_a.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.plan import pad_epochs, plan_epochs
from gps_sdr_sim_tpu_torch.testing import NAV, TOKYO
from gps_sdr_sim_tpu_torch.tools.card import time_ms

VARIANTS = ("default", "nav_gather")
TPU_ONLY = ("int_m", "int_nav", "f32_nav", "int_all", "mix", "wrap", "tree")


def staged_batch(batch_epochs: int, device):
    """The harness's batch: `batch_epochs` epochs of Tokyo static at
    2.6 Msps on `device`. Returns (Staged, samples per epoch)."""
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO,
        duration=0.1 * (batch_epochs + 2), samp_freq=2.6e6))
    eb = pad_epochs(plan_epochs(scn.segments[0], 0, batch_epochs, scn.delt),
                    batch_epochs)
    return synth.stage_epochs(eb, device), scn.iq_buff_size


def interleaved_times(fns: dict, passes: int = 7, reps: int = 4,
                      device="cuda") -> dict:
    """Time the callables {name: fn} in turns: each rep times a burst of
    `passes` calls of each, best of the burst (CUDA events on a card, the
    host clock otherwise), and the burst order alternates from rep to rep
    so that a drifting clock favours none. No warm-up: the caller has
    called each fn once. Returns {name: [best s of each rep]}."""
    times = {name: [] for name in fns}
    order = list(fns.items())
    for rep in range(reps):
        for name, fn in (order if rep % 2 == 0 else order[::-1]):
            best = time_ms(fn, passes, device, warm=False) / 1e3
            times[name].append(best)
            print(f"rep{rep} {name}: {best:.6f} s", file=sys.stderr)
    return times


def compare(fns: dict, passes: int = 7, reps: int = 4,
            device="cuda") -> dict:
    """Variants {name: fn} of one computation, a first and b last (one
    entry for an A/A run): check that they return equal tensors, then time
    them with interleaved_times (the check warms every variant). Returns
    {"bit_equal"} and, when equal, {"reps_s", "best_s", "b_over_a"}."""
    outs = [fn() for fn in fns.values()]
    outs = [(o,) if torch.is_tensor(o) else o for o in outs]
    out = {"bit_equal": all(torch.equal(x, y) for o in outs[1:]
                            for x, y in zip(outs[0], o))}
    del outs
    if not out["bit_equal"]:
        return out
    times = interleaved_times(fns, passes, reps, device)
    best = {name: min(t) for name, t in times.items()}
    names = list(fns)
    a, b = names[0], names[-1]
    out.update(reps_s=times, best_s=best, b_over_a=best[b] / best[a])
    return out


def run_ab(a: str, b: str, fmt: int = 16, batch_epochs: int = 400,
           passes: int = 7, reps: int = 4, device="cuda") -> dict:
    """Variants a and b of the packed-word kernel on the harness's batch,
    through compare(). Returns the summary; on a mismatch it holds
    bit_equal False and no times."""
    for v in (a, b):
        if v in TPU_ONLY:
            raise ValueError(f"variant {v!r} is a lowering choice of the TPU "
                             f"kernel with no counterpart in the port; the "
                             f"port's variants are {VARIANTS}")
        if v not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {v!r}")
    device = torch.device(device)
    staged, n = staged_batch(batch_epochs, device)

    def variant(name):
        return lambda: synth.synth_wire(
            staged.wire, staged.ca_words, staged.n_chan, n, fmt,
            nav_gather=name == "nav_gather")

    out = {"metric": "kernel_variant_ab", "a": a, "b": b, "fmt": fmt,
           "epochs": batch_epochs, "samples": batch_epochs * n,
           "n_chan": staged.n_chan, "backend": device.type,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    out.update(compare({name: variant(name) for name in dict.fromkeys((a, b))},
                       passes, reps, device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.ab_kernel")
    ap.add_argument("--a", default="default")
    ap.add_argument("--b", required=True)
    ap.add_argument("--fmt", type=int, default=16, choices=(16, 8, 1))
    ap.add_argument("--batch-epochs", type=int, default=400)
    ap.add_argument("--passes", type=int, default=7)
    ap.add_argument("--reps", type=int, default=4,
                    help="use an even count: the burst order alternates")
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU (plumbing only)")
    ap.add_argument("--json", default="")
    ns = ap.parse_args(argv)
    if not ns.cpu and not torch.cuda.is_available():
        print("ERROR: no CUDA device (use --cpu to smoke-test the plumbing)",
              file=sys.stderr)
        return 1
    try:
        out = run_ab(ns.a, ns.b, ns.fmt, ns.batch_epochs, ns.passes, ns.reps,
                     "cpu" if ns.cpu else "cuda")
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    if not out["bit_equal"]:
        print(f"MISMATCH: {ns.a} and {ns.b} write different words",
              file=sys.stderr)
        return 1
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
