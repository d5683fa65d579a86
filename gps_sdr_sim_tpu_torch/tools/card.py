"""What the tools and chip_smoke.py share about the card: its name and power
limit as nvidia-smi gives them, and one timer."""

from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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
