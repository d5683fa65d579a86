"""End-to-end simulation runner: scenario -> device batches -> output file.

Counterpart of gps_sdr_sim_tpu/runner.py on the single-device packed path.
Per batch of 0.1 s epochs the host plans (NumPy, ops/plan.py), uploads the
wire from pinned memory without waiting, launches the synthesis, and starts
an asynchronous device-to-host copy, all on the device's current stream; so
the host plans batch k+1 while the device runs batch k. The writer drains
batches in order, so the byte stream is the reference's sequential one.
Batches are padded to `batch_epochs` with gain-0 epochs, and only the valid
epochs are written.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import BinaryIO, Callable, Optional

import numpy as np
import torch

from gps_sdr_sim_tpu.models.scenario import Scenario
from gps_sdr_sim_tpu.ops.plan import pad_epochs, plan_epochs
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.quantize import words_to_bytes

IMPLS = ("cuda", "torch")

# Batches in flight before the writer blocks on the oldest.
_QUEUE_DEPTH = 4


@dataclass
class RunStats:
    total_samples: int = 0
    wall_seconds: float = 0.0
    device_batches: int = 0
    plan_seconds: float = 0.0   # host planning and enqueueing (no waits)
    fetch_seconds: float = 0.0  # blocked on the device: kernel + readback
    write_seconds: float = 0.0  # file writes

    @property
    def samples_per_second(self) -> float:
        return self.total_samples / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self, samp_freq: float) -> dict:
        return {
            "total_samples": self.total_samples,
            "device_batches": self.device_batches,
            "wall_seconds": round(self.wall_seconds, 3),
            "plan_seconds": round(self.plan_seconds, 3),
            "fetch_seconds": round(self.fetch_seconds, 3),
            "write_seconds": round(self.write_seconds, 3),
            "samples_per_second": round(self.samples_per_second, 1),
            "realtime_factor": round(
                self.samples_per_second / samp_freq, 2) if samp_freq else 0.0,
        }


def iter_segment_batches(segments, lo: int, hi: int, batch_epochs: int):
    """Yield (segment, e0, e1) covering output epochs [lo, hi) in order.

    Output epoch k (0-based) is synthesized by segment-local epoch
    k - (first_epoch - 1) of the segment containing it."""
    for seg in segments:
        s0 = seg.first_epoch - 1
        a, b = max(lo, s0), min(hi, s0 + seg.n_epochs)
        e = a - s0
        while e < b - s0:
            step = min(batch_epochs, (b - s0) - e)
            yield seg, e, e + step
            e += step


def iter_seg_batches(scn: Scenario, lo: int, hi: int, batch_epochs: int):
    """iter_segment_batches over a fully-materialized Scenario."""
    return iter_segment_batches(scn.segments, lo, hi, batch_epochs)


def resolve_device(impl: str, device) -> torch.device:
    """The device a run of `impl` uses; raises ValueError or RuntimeError
    if it cannot run there (no silent fallback to the CPU)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = torch.device(device)
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl 'cuda' runs the CUDA kernel and needs a CUDA "
                         f"device, got '{device}'; impl 'torch' runs the "
                         f"plain PyTorch version on any device")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"CUDA device '{device}' is not available")
    return device


def fetch_async(out: torch.Tensor):
    """Start the copy of device words `out` into pinned host memory.

    Returns (host tensor, event). The copy is queued on the current stream
    of out's device, which need not be the current device, so the event is
    recorded on that same stream: its completion marks the copy's."""
    host = out.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return host, done


def run_epoch_range(scn: Scenario, fp: BinaryIO, lo: int, hi: int,
                    batch_epochs: int = 20,
                    log: Optional[Callable[[str], None]] = None,
                    impl: str = "cuda", device="cuda") -> RunStats:
    """Synthesize output epochs [lo, hi) of `scn` into `fp`.

    impl: "cuda" (the hand-written kernel; needs a CUDA device) or "torch"
    (the kernel's plain PyTorch version, on `device`)."""
    if log is None:
        log = lambda s: print(s, end="", file=sys.stderr, flush=True)
    device = resolve_device(impl, device)
    n = scn.iq_buff_size
    fmt = scn.config.data_format
    on_cuda = device.type == "cuda"
    stats = RunStats()
    t_start = time.time()
    pending = deque()  # (host words, copy-done event or None, valid epochs)

    def flush(item):
        host, done, valid = item
        t0 = time.time()
        if done is not None:
            done.synchronize()
        t1 = time.time()
        fp.write(np.ascontiguousarray(
            words_to_bytes(host.numpy()[:valid], n, fmt)).data)
        stats.fetch_seconds += t1 - t0
        stats.write_seconds += time.time() - t1

    for seg, e, e1 in iter_seg_batches(scn, lo, hi, batch_epochs):
        t_plan = time.time()
        staged = synth.stage_epochs(pad_epochs(
            plan_epochs(seg, e, e1, scn.delt), batch_epochs), device)
        out = synth.synth_staged_packed(staged, n, fmt,
                                        plain=impl == "torch")
        done = None
        if on_cuda:
            out, done = fetch_async(out)
        stats.plan_seconds += time.time() - t_plan
        if len(pending) >= _QUEUE_DEPTH:
            flush(pending.popleft())
        pending.append((out, done, e1 - e))
        stats.device_batches += 1
        stats.total_samples += (e1 - e) * n
        log(f"\rTime into run = {(seg.first_epoch + e1 - 1) * 0.1:4.1f}")

    while pending:
        flush(pending.popleft())

    stats.wall_seconds = time.time() - t_start
    return stats


def run_simulation(scn: Scenario, fp: BinaryIO, batch_epochs: int = 20,
                   log: Optional[Callable[[str], None]] = None,
                   impl: str = "cuda", device="cuda") -> RunStats:
    """Synthesize the whole scenario into `fp`. Returns throughput stats."""
    return run_epoch_range(scn, fp, 0, scn.n_output_epochs,
                           batch_epochs=batch_epochs, log=log, impl=impl,
                           device=device)
