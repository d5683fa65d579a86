"""What the tools and chip_smoke.py share about the card: its name and power
limit as nvidia-smi gives them, one timer, the card's published rates, and
the synthesis algorithm's operation count that every bound and roofline
divides by them."""

from __future__ import annotations

import subprocess
import time

import torch

# NVIDIA H100 SXM at its 700 W limit (published peak rates): HBM3 rate, and
# one 32-bit instruction per lane per clock on every scheduler, i.e. the
# 67 TFLOP/s float32 rate counted in FMAs.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2
# The dense int8 tensor-core rate (receiver.acquire_mxu's products).
INT8_OPS_PER_S = 1979e12
# The integer operations the synthesis algorithm needs, whatever the
# kernel's design: per (sample, channel whose gain is not 0), advance the
# code phase, whole-chip index, its wrap into the 1023-chip code period,
# C/A bit, nav bit, sign = C/A xor nav, advance the carrier phase,
# trig-table index, cos and sin lookups, two gain products and two signed
# sums; per quantized sample (planes and the packed formats, not the raw
# sums) the rounding and packing. The wrap counts because the function
# reads the C/A chip at the chip count mod 1023, whatever a design does to
# avoid a per-sample wrap; chip_smoke.py also prints the share the bound
# would give without it (13 per pair), beside the one it gives.
ALGORITHM_OPS = {"code phase": 1, "whole chip": 1, "code period wrap": 1,
                 "C/A bit": 1, "nav bit": 1, "sign": 1, "carrier phase": 1,
                 "table index": 1, "cos and sin": 2, "gain products": 2,
                 "signed sums": 2}
OPS_PER_SAMPLE_CHANNEL = sum(ALGORITHM_OPS.values())  # 14
OPS_PER_QUANTIZED_SAMPLE = 4


def card_line(index: int = 0) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of card `index` (the
    first by default)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[index]


def time_ms(fn, reps: int = 1, device="cuda", warm: bool = True) -> float:
    """Best of `reps` calls of fn, each timed alone, in ms. On a CUDA
    device each call sits between its own pair of events on the current
    stream, and all calls are queued before the host waits, so the card
    does not idle while the host prepares the next launch and the time is
    the device's. Otherwise the host clock. With warm, one untimed call
    comes first."""
    cuda = torch.device(device).type == "cuda"
    if warm:
        fn()
        if cuda:
            torch.cuda.synchronize()
    if not cuda:
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) * 1e3)
        return best
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    events[-1][1].synchronize()
    return min(start.elapsed_time(end) for start, end in events)


def bound_ms(in_bytes: int, out_bytes: int,
             operations: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over the issue rate. Returns (ms, "bytes" or
    "operations")."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = operations / ISSUE_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def synth_operations(sample_channels: int, samples: int,
                     quantized: bool) -> int:
    """The algorithm's operations for `sample_channels` (sample, channel
    with gain) pairs over `samples` output samples (ALGORITHM_OPS), the
    same for every design of the kernel."""
    return (OPS_PER_SAMPLE_CHANNEL * sample_channels
            + (OPS_PER_QUANTIZED_SAMPLE * samples if quantized else 0))
