"""Measure the card's delivered int32 throughput in the synthesis kernel's
op mix.

Counterpart of tools/vpu_peak.py. The kernel (csrc/vpu_peak.cu) runs, for
each element of a (16, 128) int32 seed block repeated over `tiles`,
`rounds` rounds of 8 dependent chains seeded from runtime data, in five
cases:

  alu     32 add / xor-shift ops per round: the integer issue ceiling;
  gather  the same plus 4 lookups of a 128-entry shared-memory table (the
          synthesis kernel's C/A, sin/cos and nav-table lookups);
  mix     38 ops and 2 lookups;
  imul    the alu chains plus 4 int32 multiplies;
  f32rt   the alu chains plus 4 float32 round trips (convert, + 0.5,
          * 1/1023, floor, convert).

`alu/4` (a quarter of the rounds) is the fold check: the full run must
take at least 1.5 times as long, or the compiler simplified the chains
away. The two alu runs also give a two-point fit that removes launch and
write overhead from the peak. Each case reports source ops/s and, from
`cuobjdump -sass`, the SASS instructions of one round and instructions/s:
IADD3 and LOP3 fuse source ops, so the two rates differ, and the second is
the one to hold against a published issue rate.

Usage: python -m gps_sdr_sim_tpu_torch.tools.vpu_peak [--json FILE]
           [--tiles 2048] [--rounds 2048] [--reps 5] [--device cuda]
Needs a CUDA device. Every timed run's words are held against the plain
version (`vpu_peak_ref`) at the run's own shape. The summary goes to
--json FILE only; one JSON line goes to stdout.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.tools.card import card_line, time_ms

SLAB = 16   # rows of the seed block, the synthesis kernel's (16, 128) slab
LANES = 128
N_ACC = 8   # independent chains per round

# name -> (launcher kind, alu ops, gathers, extra op, extras) per round,
# as tools/vpu_peak.py:184-193 runs them.
CASES = {
    "alu": (0, 32, 0, "", 0),
    "gather": (1, 32, 4, "", 0),
    "mix": (2, 38, 2, "", 0),
    "imul": (3, 32, 0, "imul", 4),
    "f32rt": (4, 32, 0, "f32rt", 4),
}
_EXTRA_ID = {"": 0, "imul": 1, "f32rt": 2}

# Launches of the kernel, counted where the wrapper launches it.
launch_counts = {"vpu_peak": 0}

_lib = None


def inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The seed block and the table of tools/vpu_peak.py:_run_case."""
    rng = np.random.default_rng(7)
    seed = rng.integers(0, 1 << 20, size=(SLAB, LANES), dtype=np.int32)
    table = np.arange(LANES, dtype=np.int32)
    return (torch.from_numpy(seed).to(device),
            torch.from_numpy(table).to(device))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def vpu_peak_ref(seed: torch.Tensor, table: torch.Tensor, tiles: int,
                 rounds: int, case: str) -> torch.Tensor:
    """Plain PyTorch version: the [tiles * 16, 128] int32 words the kernel
    writes (every tile starts from the same seed block). int64 arithmetic
    wrapped to int32 where the kernel's uint32 chains wrap."""
    _, alu, gathers, extra, n_extra = CASES[case]
    s = seed.to(torch.int64)
    tbl = table.to(torch.int64)
    inv1023 = torch.tensor(np.float32(1.0 / 1023.0), device=seed.device)
    acc = [_wrap32(s + c) for c in range(N_ACC)]
    for _ in range(rounds):
        for j in range(alu):
            c = j % N_ACC
            if (j // N_ACC) % 2 == 0:
                acc[c] = _wrap32(acc[c] + acc[(c + 3) % N_ACC])
            else:
                acc[c] = acc[c] ^ (acc[(c + 1) % N_ACC] >> 1)
        for j in range(gathers):
            c = (j + 1) % N_ACC
            acc[c] = _wrap32(acc[c] + tbl[acc[c] & 127])
        for j in range(n_extra):
            c = (j + 5) % N_ACC
            if extra == "imul":
                acc[c] = _wrap32(acc[c] * acc[(c + 3) % N_ACC])
            else:
                t = (acc[(c + 3) % N_ACC] & 0xFFFFF).to(torch.float32)
                m = torch.floor((t + 0.5) * inv1023).to(torch.int64)
                acc[c] = _wrap32(acc[c] + m)
    out = acc[0]
    for c in range(1, N_ACC):
        out = out ^ acc[c]
    return out.to(torch.int32).repeat(tiles, 1)


def _load():
    global _lib
    if _lib is None:
        import ctypes

        from gps_sdr_sim_tpu_torch.ops import synth_cuda

        lib = ctypes.CDLL(str(synth_cuda.build(synth_cuda.VPU_PEAK_SOURCE)))
        lib.vpu_peak_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.vpu_peak_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def vpu_peak(seed: torch.Tensor, table: torch.Tensor, tiles: int,
             rounds: int, case: str) -> torch.Tensor:
    """[16, 128] seed, [128] table -> [tiles * 16, 128] int32 words.

    CUDA tensors go through csrc/vpu_peak.cu (a build or launch failure
    raises); CPU tensors through vpu_peak_ref."""
    if case not in CASES:
        raise ValueError(f"case must be one of {sorted(CASES)}, got {case!r}")
    if seed.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("seed and table must be int32")
    if tuple(seed.shape) != (SLAB, LANES) or tuple(table.shape) != (LANES,):
        raise ValueError(f"seed must be [{SLAB}, {LANES}] and table "
                         f"[{LANES}]")
    if not (seed.is_contiguous() and table.is_contiguous()):
        raise ValueError("seed and table must be contiguous")
    if seed.device != table.device:
        raise ValueError("seed and table are on different devices")
    if tiles < 1 or rounds < 0:
        raise ValueError(f"tiles {tiles} < 1 or rounds {rounds} < 0")
    if seed.device.type == "cpu":
        return vpu_peak_ref(seed, table, tiles, rounds, case)
    if seed.device.type != "cuda":
        raise ValueError(f"no kernel for device {seed.device}")
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    out = torch.empty((tiles * SLAB, LANES), dtype=torch.int32,
                      device=seed.device)
    synth_cuda.call(_load(), "vpu_peak_launch", seed.device, seed.data_ptr(),
                    table.data_ptr(), out.data_ptr(), tiles, rounds,
                    CASES[case][0])
    launch_counts["vpu_peak"] += 1
    return out


def round_instructions(loops: dict) -> dict:
    """{case: SASS instructions of one round} from synth_cuda.sass_loops of
    the built library: the round loop (kept rolled) of each case's
    instantiation, vpu_peak_kernel<ALU, GATHERS, EXTRA, N_EXTRA>."""
    by_args = {(alu, g, _EXTRA_ID[x], n): name
               for name, (_, alu, g, x, n) in CASES.items()}
    counts = {}
    for fn, found in loops.items():
        m = re.match(r"\S*vpu_peak_kernelILi(\d+)ELi(\d+)ELi(\d)ELi(\d)E", fn)
        if m:
            if len(found) != 1:
                raise AssertionError(f"{fn}: {len(found)} loops, expected "
                                     f"the round loop alone")
            counts[by_args[tuple(int(v) for v in m.groups())]] = len(found[0])
    if sorted(counts) != sorted(CASES):
        raise AssertionError(f"SASS holds vpu_peak cases {sorted(counts)}")
    return counts


def measure(device, tiles: int = 2048, rounds: int = 2048,
            reps: int = 5) -> dict:
    """Time every case and the alu/4 fold check on `device` (a CUDA
    device), holding each run's words against vpu_peak_ref at that run's
    shape. Raises AssertionError if any run differs from its plain version
    or the fold check fails."""
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"vpu_peak measures a CUDA device, got {device}")
    seed, table = inputs(device)
    sass_per_round = round_instructions(synth_cuda.sass_loops(
        synth_cuda.sass(synth_cuda.build(synth_cuda.VPU_PEAK_SOURCE))))

    elems = tiles * SLAB * LANES
    cases, worst = [], 0
    runs = [("alu/4", "alu", rounds // 4)] + [(c, c, rounds) for c in CASES]
    for label, case, n_rounds in runs:
        got, want = [], []
        ms = time_ms(lambda: got.append(vpu_peak(seed, table, tiles,
                                                 n_rounds, case)), reps)
        plain_ms = time_ms(lambda: want.append(vpu_peak_ref(
            seed, table, tiles, n_rounds, case)), 1, warm=False)
        got, want = got[-1], want[0]
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"vpu_peak kernel != plain version: "
                                 f"{label}, {tiles} tiles x {n_rounds} "
                                 f"rounds")
        del got, want
        _, alu, gathers, extra, n_extra = CASES[case]
        ops = elems * n_rounds * (alu + gathers)  # a gather counts as one op
        ins = elems * n_rounds * sass_per_round[case]
        cases.append({"name": label, "ms": ms, "plain_ms": plain_ms,
                      "rounds": n_rounds,
                      "tiles": tiles, "alu_per_round": alu,
                      "gathers_per_round": gathers, "extra": extra,
                      "extra_per_round": n_extra,
                      "sass_per_round": sass_per_round[case],
                      "source_ops_per_s": ops / ms * 1e3,
                      "sass_per_s": ins / ms * 1e3})
    by = {c["name"]: c for c in cases}
    small, alu = by["alu/4"], by["alu"]
    if alu["ms"] < 1.5 * small["ms"]:
        raise AssertionError(f"fold check failed: alu {alu['ms']:.4f} ms < "
                             f"1.5 x alu/4 {small['ms']:.4f} ms")
    # Seconds per round, without the fixed launch and write overhead.
    slope = (alu["ms"] - small["ms"]) / 1e3 / (rounds - rounds // 4)
    peak_ops = elems * 32 / slope
    peak_sass = elems * sass_per_round["alu"] / slope

    def marginal(case, per_round):
        """Cost of one extra op of `case`, in alu-op equivalents."""
        extra_s = (by[case]["ms"] - alu["ms"]) / 1e3 / (rounds * per_round)
        return extra_s * peak_ops / elems

    return {
        "device": torch.cuda.get_device_name(device),
        "card": card_line(),
        "peak_source_ops_per_s": peak_ops,
        "peak_sass_per_s": peak_sass,
        "max_abs_err": worst,
        "fold_check": {"alu_ms": alu["ms"], "alu4_ms": small["ms"]},
        "gather_cost_alu_ops": marginal("gather", 4),
        "imul_cost_alu_ops": marginal("imul", 4),
        "f32_roundtrip_cost_alu_ops": marginal("f32rt", 4),
        "cases": cases,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.vpu_peak")
    ap.add_argument("--json", default="", help="write the summary here")
    ap.add_argument("--tiles", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ERROR: vpu_peak needs a CUDA device", file=sys.stderr)
        return 1
    out = measure(ns.device, ns.tiles, ns.rounds, ns.reps)
    for c in out["cases"]:
        print(f"{c['name']:7s}: {c['ms']:9.4f} ms  "
              f"{c['source_ops_per_s'] / 1e12:7.3f} T source ops/s  "
              f"{c['sass_per_s'] / 1e12:7.3f} T SASS instr/s "
              f"({c['sass_per_round']} per round)", file=sys.stderr)
    if ns.json:
        with open(ns.json, "w") as fp:
            json.dump(out, fp, indent=1)
            fp.write("\n")
    print(json.dumps({k: out[k] for k in (
        "device", "card", "peak_source_ops_per_s", "peak_sass_per_s")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
