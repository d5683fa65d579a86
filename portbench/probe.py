"""The copy rates of the card's link and of the host's memory, read in each
run once its window has closed and printed on stderr beside the window's
diagnosis. The cells' rt_factor is paced by the readback, so a run that
reads far off shows here whether the link or the host was slower then.

Each rate is the median of `reps` copies of `nbytes` (one SC16 batch of the
cells: 100 epochs of 260,000 samples): device to pinned host memory and
back, timed by CUDA events, and pinned to pageable host memory, timed by
the host's clock.
"""

from __future__ import annotations

import statistics
import time

NBYTES = 104_000_000


def rates(device, nbytes: int = NBYTES, reps: int = 10) -> dict:
    """{d2h_gb_per_s, h2d_gb_per_s, host_copy_gb_per_s} on card `device`."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    dev.fill_(1)
    out = {}
    for name, dst, src in (("d2h_gb_per_s", pinned, dev),
                           ("h2d_gb_per_s", dev, pinned)):
        times = []
        for _ in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        out[name] = nbytes / statistics.median(times[1:]) / 1e9
    times = []
    for _ in range(reps + 1):
        t = time.perf_counter()
        pageable.copy_(pinned)
        times.append(time.perf_counter() - t)
    out["host_copy_gb_per_s"] = nbytes / statistics.median(times[1:]) / 1e9
    del dev, pinned, pageable
    torch.cuda.empty_cache()
    return out
