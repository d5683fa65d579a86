"""Static instruction budget of the synthesis kernel's channel loop.

Counterpart of tools/op_budget.py. There the Mosaic MLIR of the Pallas
kernel was captured and its vector ops counted by class; here the SASS of
every instantiation of the production library (csrc/synth.cu) and of the
cost-attribution library (csrc/synth_profile.cu, the ablated variants) is
read with `cuobjdump -sass` (ops/synth_cuda.py sass, sass_loops), and its
channel loop counted:

1. The channel loop is the longest loop of the kernel (rolled, one trip
   per (thread, channel), covering the SAMPLES_PER_TRIP samples the thread
   owns): synth_cuda.channel_loops, the finder that chip_smoke.py phase 2
   reads through channel_loop_instructions.
2. The trip is split into the per-sample body (what repeats
   SAMPLES_PER_TRIP times) and the channel's per-thread setup (the rest of
   the trip): each opcode, modifiers included, counts in the body the
   nearest whole number of times per sample, and what is left over is
   setup. The first sample skips the phase step, so the rest is the
   setup's own instructions less those the first sample skips, both also
   reported (per opcode they net: an opcode of both counts by its
   difference).
3. Each is counted by class (CLASSES): integer adds, multiplies (IMAD and
   IMUL that multiply, apart from the IMAD.MOV / .SHL / .IADD moves that
   nvcc puts on the FMA pipe), shifts, bitwise, compare/select, shared
   loads, global stores, warp ops, control, other.
4. The classes are priced with tools/vpu_peak's measured costs: one SASS
   instruction at the alu rate, a multiply at its imul cost and a shared
   load at its gather cost, both converted from alu source ops to SASS
   instructions. The costs come from the profile's JSON (--profile FILE:
   tools/profile_kernel measures vpu_peak in its own process) or, without
   one, from a vpu_peak run here. The predicted ns per (sample, channel)
   is reconciled with profile_kernel's slope and with each of its
   variants' measured time. A shared load is priced at its standalone
   cost in vpu_peak, where independent chains hide its latency; what the
   prediction misses is what the loop's own dependences expose.
-Xptxas -v's registers, shared memory and spills stand beside each.

Every instantiation is reported, each time. The JAX tool's int_m variant
(the integer code-period count) is a lowering choice of the TPU kernel and
has no counterpart here; its default, sc08 and sc01 are the production
synth_wire/16, /8 and /1, under whose names the summary line reports them.

Usage: python -m gps_sdr_sim_tpu_torch.tools.op_budget [--json FILE]
           [--dump-dir DIR] [--profile FILE] [--sass-dir DIR] [--cpu]
Without --cpu it needs a card (and nvcc), and does not fall back. --cpu
prices only from --profile and measures nothing; with --sass-dir DIR it
reads the SASS and -Xptxas -v text that --dump-dir wrote (on the card's
machine) instead of building, so it runs here. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import torch

from gps_sdr_sim_tpu_torch.ops import synth_cuda

# SASS opcode classes, matched in order on the mnemonic before its first
# modifier (IMAD.MOV.U32 is a move, IMAD.WIDE.U32 a multiply).
CLASSES = (
    ("add", r"IADD3|IADD"),
    ("imad_move", r"IMAD\.(MOV|SHL|IADD)"),
    ("multiply", r"IMAD|IMUL"),
    ("shift", r"SHF|SHL|SHR|LEA"),
    ("bitwise", r"LOP3|LOP"),
    ("compare_select", r"ISETP|ICMP|SEL|FSEL|PLOP3"),
    ("shared_load", r"LDS"),
    ("global_store", r"STG"),
    ("warp", r"REDUX|VOTE|SHFL|MATCH"),
    ("control", r"BRA|BAR|EXIT|BSSY|BSYNC|WARPSYNC|CALL|RET|NOP|YIELD|"
                r"BREAK|JMP"),
)
CLASS_NAMES = tuple(name for name, _ in CLASSES) + ("other",)
_CLASS_RE = [(name, re.compile(rf"(?:{pat})(?:\.|$)"))
             for name, pat in CLASSES]
# The JAX tool's variant names of the production instantiations, for the
# summary line's keys.
JAX_VARIANTS = {"default": "synth_wire/16", "sc08": "synth_wire/8",
                "sc01": "synth_wire/1"}
# profile_kernel's variants by instantiation key.
PROFILE_VARIANTS = {"full": "synth_wire/16", "full_sc08": "synth_wire/8",
                    "full_sc01": "synth_wire/1",
                    **{name: f"synth_wire/16/{name}"
                       for name in synth_cuda.ABLATION_SETS}}
LIBRARIES = {"synth": synth_cuda.SOURCE,
             "synth_profile": synth_cuda.PROFILE_SOURCE}


def classify(op: str) -> str:
    """The class of a SASS mnemonic (predicate stripped), CLASS_NAMES."""
    for name, pat in _CLASS_RE:
        if pat.match(op):
            return name
    return "other"


def by_class(ops: dict) -> dict:
    """{opcode: count} -> {class: count} over CLASS_NAMES."""
    out = dict.fromkeys(CLASS_NAMES, 0)
    for op, n in ops.items():
        out[classify(op)] += n
    return out


def split_trip(trip: list, samples: int = synth_cuda.SAMPLES_PER_TRIP):
    """(body, setup) of one trip of the channel loop: body {opcode: count
    per sample}, each opcode's count over `samples` rounded to the nearest
    whole number (half down), and setup {opcode: count per trip}, the rest
    (trip = samples * body + setup)."""
    counts = Counter(trip)
    body = {op: (n + samples // 2 - 1) // samples for op, n in counts.items()}
    setup = {op: n - samples * body[op] for op, n in counts.items()}
    return ({op: n for op, n in body.items() if n},
            {op: n for op, n in setup.items() if n})


def budget(sass_text: str, ptxas_text: str, library: str) -> dict:
    """{instantiation key: budget} of one library's SASS and -Xptxas -v
    text: the channel loop's instructions per (sample, channel), its body
    and setup by opcode and class, and registers, shared memory, spills.
    Raises AssertionError unless its SASS and -Xptxas -v text hold exactly
    its instantiations (synth_cuda.all_instantiation_keys for "synth",
    all_profile_keys for "synth_profile")."""
    if library == "synth":
        key_of, want = (synth_cuda.instantiation_key,
                        synth_cuda.all_instantiation_keys())
    else:
        key_of, want = (synth_cuda.profile_instantiation_key,
                        synth_cuda.all_profile_keys())
    trips = synth_cuda.channel_loops(synth_cuda.sass_loops(sass_text),
                                     key_of, want)
    usage = {key_of(fn): u for fn, u in
             synth_cuda.ptxas_usage(ptxas_text).items() if key_of(fn)}
    if sorted(usage) != sorted(want):
        raise AssertionError(f"{library}: -Xptxas -v holds {sorted(usage)}")
    S = synth_cuda.SAMPLES_PER_TRIP
    out = {}
    for key, trip in trips.items():
        body, setup = split_trip(trip, S)
        cls_body, cls_setup = by_class(body), by_class(setup)
        out[key] = {
            "library": library,
            "trip_sass": len(trip),
            "sass_per_chan_sample": len(trip) / S,
            "body_per_sample": sum(body.values()),
            "setup_per_trip": sum(setup.values()),
            "setup_own_per_trip": sum(n for n in setup.values() if n > 0),
            "skipped_by_first_sample_per_trip": -sum(
                n for n in setup.values() if n < 0),
            "setup_per_chan_sample": sum(setup.values()) / S,
            "classes_body_per_sample": cls_body,
            "classes_setup_per_trip": cls_setup,
            "classes_per_chan_sample": {
                c: cls_body[c] + cls_setup[c] / S for c in CLASS_NAMES},
            "opcodes_body_per_sample": body,
            "opcodes_setup_per_trip": setup,
            "ptxas": usage[key],
        }
    return out


def costs(peak: dict) -> dict:
    """SASS-instruction costs of a multiply and a shared load, and the alu
    SASS rate, from a vpu_peak result (its costs are in alu source ops)."""
    per_source = peak["peak_sass_per_s"] / peak["peak_source_ops_per_s"]
    return {"alu_sass_per_s": peak["peak_sass_per_s"],
            "sass_per_alu_source_op": per_source,
            "multiply_sass": peak["imul_cost_alu_ops"] * per_source,
            "shared_load_sass": peak["gather_cost_alu_ops"] * per_source}


def price(classes: dict, cost: dict) -> dict:
    """Instruction equivalents and ns per (sample, channel) of a
    classes_per_chan_sample dict."""
    equiv = sum(n * cost.get(f"{c}_sass", 1.0) for c, n in classes.items())
    return {"equiv_sass_per_chan_sample": equiv,
            "predicted_ns_per_chan_sample": equiv / cost["alu_sass_per_s"]
            * 1e9}


def reconcile(found: dict, prof: dict) -> dict:
    """Predicted against measured ns per (sample, channel): each profile
    variant's best time, and the full kernel's slope."""
    rows = {}
    for name, r in prof.get("rows", {}).items():
        key = PROFILE_VARIANTS[name]
        measured = r["best_s"] / r["chan_samples"] * 1e9
        predicted = found[key]["pricing"]["predicted_ns_per_chan_sample"]
        rows[name] = {"instantiation": key,
                      "measured_ns_per_chan_sample": measured,
                      "predicted_ns_per_chan_sample": predicted,
                      "predicted_over_measured": predicted / measured}
    slope = prof["overhead_separation"]["kernel_slope_ns_per_chan_sample"]
    full = found["synth_wire/16"]["pricing"]["predicted_ns_per_chan_sample"]
    return {"variants": rows,
            "kernel_slope_ns_per_chan_sample": slope,
            "full_predicted_over_slope": full / slope}


def read_libraries(sass_dir: str = "") -> dict:
    """{library: (SASS text, -Xptxas -v text)}: built (both side by side)
    and disassembled, or read from a --dump-dir directory."""
    if sass_dir:
        d = pathlib.Path(sass_dir)
        return {name: ((d / f"{name}.sass").read_text(),
                       (d / f"{name}.ptxas.txt").read_text())
                for name in LIBRARIES}
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(synth_cuda.build,
                                            LIBRARIES.values())))
    return {name: (synth_cuda.sass(lib), synth_cuda.build_log(lib))
            for name, lib in libs.items()}


def op_budget(texts: dict, peak=None, prof=None) -> dict:
    """The budget of every instantiation of both libraries, priced with
    `peak` (a vpu_peak result, or None) and reconciled with `prof` (a
    profile_kernel JSON, or None)."""
    found = {}
    for name, (sass_text, ptxas_text) in texts.items():
        found.update(budget(sass_text, ptxas_text, name))
    cost = costs(peak) if peak else None
    if cost:
        for b in found.values():
            b["pricing"] = price(b["classes_per_chan_sample"], cost)
    out = {
        "metric": "kernel_static_op_budget",
        "geometry": {"threads": 128,
                     "samples_per_trip": synth_cuda.SAMPLES_PER_TRIP},
        "method": ("cuobjdump -sass of both libraries; each "
                   "instantiation's channel loop (its longest loop) split "
                   "into the per-sample body and the setup, counted by "
                   "opcode class, over the SAMPLES_PER_TRIP samples of a "
                   "trip"),
        "instantiations": found,
        "pricing_costs": cost,
        "card": peak.get("card") if peak else None,
        "reconcile": reconcile(found, prof) if cost and prof else None,
    }
    return out


def summary(out: dict) -> dict:
    """The stdout line: the JAX tool's keys, in SASS instructions."""
    inst = out["instantiations"]
    line = {f"{v}_sass_per_chan_sample": inst[k]["sass_per_chan_sample"]
            for v, k in JAX_VARIANTS.items()}
    line.update({f"{k}_sass_per_chan_sample": v["sass_per_chan_sample"]
                 for k, v in inst.items() if k.count("/") == 2})
    full = inst["synth_wire/16"]
    line["default_body_per_sample"] = full["body_per_sample"]
    line["default_setup_per_chan_sample"] = full["setup_per_chan_sample"]
    line["predicted_equiv_ops_per_chan_sample"] = (
        full["pricing"]["equiv_sass_per_chan_sample"]
        if "pricing" in full else None)
    rec = out["reconcile"]
    line["full_predicted_over_slope"] = (
        rec["full_predicted_over_slope"] if rec else None)
    line["card"] = out["card"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.op_budget")
    ap.add_argument("--json", default="", help="write all of it here")
    ap.add_argument("--dump-dir", default="",
                    help="also save each library's SASS and -Xptxas -v text")
    ap.add_argument("--sass-dir", default="",
                    help="read them from a --dump-dir directory instead of "
                         "building")
    ap.add_argument("--profile", default="",
                    help="profile_kernel's --json FILE: its vpu_peak costs "
                         "price the classes, its times are reconciled")
    ap.add_argument("--cpu", action="store_true",
                    help="measure nothing on a card (price from --profile)")
    ns = ap.parse_args(argv)
    if not ns.cpu and not torch.cuda.is_available():
        print("ERROR: no CUDA device (use --cpu with --profile and "
              "--sass-dir to read a card's results here)", file=sys.stderr)
        return 1
    prof = json.loads(pathlib.Path(ns.profile).read_text()) \
        if ns.profile else None
    peak = prof.get("vpu_peak_ref") if prof else None
    if peak is None and not ns.cpu:
        from gps_sdr_sim_tpu_torch.tools import vpu_peak

        peak = vpu_peak.measure("cuda", tiles=2048, rounds=512, reps=3)
    texts = read_libraries(ns.sass_dir)
    if ns.dump_dir:
        d = pathlib.Path(ns.dump_dir)
        d.mkdir(parents=True, exist_ok=True)
        for name, (sass_text, ptxas_text) in texts.items():
            (d / f"{name}.sass").write_text(sass_text)
            (d / f"{name}.ptxas.txt").write_text(ptxas_text)
    out = op_budget(texts, peak, prof)
    for key, b in out["instantiations"].items():
        print(f"{key}: {b['sass_per_chan_sample']:.3f} SASS per (sample, "
              f"channel) = {b['body_per_sample']} per sample + "
              f"{b['setup_per_trip']} setup per trip of "
              f"{synth_cuda.SAMPLES_PER_TRIP} ({b['setup_own_per_trip']} "
              f"own, {b['skipped_by_first_sample_per_trip']} skipped by the "
              f"first sample); "
              + ", ".join(f"{c} {n:g}" for c, n in
                          b["classes_per_chan_sample"].items() if n),
              file=sys.stderr)
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(summary(out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
