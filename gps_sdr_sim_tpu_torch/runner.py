"""End-to-end simulation runner: scenario -> device batches -> output file.

Counterpart of gps_sdr_sim_tpu/runner.py. Per batch of 0.1 s epochs the
host plans (NumPy, ops/plan.py), uploads the wire from pinned memory
without waiting, launches the synthesis, and starts an asynchronous
device-to-host copy, all on the device's current stream; so the host plans
batch k+1 while the device runs batch k. The writer drains batches in
order, so the byte stream is the reference's sequential one. Batches are
padded to `batch_epochs` with gain-0 epochs, and only the valid epochs are
written.

The closed impls plan each batch as a DeviceBatch instead (plan_batch: the
per-sub-block rebase on the host) and synthesize it with the closed form in
plain torch (ops/synth_closed.py), the counterpart of the JAX package's
xla impls. The sharded impls run parallel/shard.py over a mesh of devices.
Both give [B, n_out, 2] samples (one piece per time shard when sharded),
packed into the format's bytes on their devices (ops/quantize.pack); each
piece is read back with its own event, and a batch is written once every
piece has landed.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import BinaryIO, Callable, Optional

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.models.scenario import Scenario
from gps_sdr_sim_tpu_torch.ops.plan import (
    DeviceBatch,
    pad_epoch_axis,
    pad_epochs,
    plan_batch,
    plan_epochs,
)
from gps_sdr_sim_tpu_torch.ops import synth, synth_closed
from gps_sdr_sim_tpu_torch.ops.quantize import pack, words_to_bytes

# cuda / torch: the packed-word kernel or its plain version on one device;
# cuda-sharded / torch-sharded: the same over a mesh (parallel/shard.py),
# the counterparts of the JAX package's pallas / pallas-sharded;
# closed / closed-sharded: the closed form in plain torch from a
# DeviceBatch, on one device or over a mesh, the counterparts of its xla /
# xla-sharded.
IMPLS = ("cuda", "torch", "cuda-sharded", "torch-sharded", "closed",
         "closed-sharded")

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


class EpochCountError(ValueError):
    """An epoch count below 1: a batch loop over it would never advance."""


def check_epoch_count(n: int, name: str = "batch_epochs") -> None:
    """Raise EpochCountError unless the epoch count `n` (named `name` in
    the message) is at least 1."""
    if n < 1:
        raise EpochCountError(f"{name} must be at least 1, got {n}")


def iter_segment_batches(segments, lo: int, hi: int, batch_epochs: int):
    """Yield (segment, e0, e1) covering output epochs [lo, hi) in order.

    Output epoch k (0-based) is synthesized by segment-local epoch
    k - (first_epoch - 1) of the segment containing it. Raises ValueError
    if batch_epochs < 1 (it would never advance)."""
    check_epoch_count(batch_epochs)
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


def _pad_batch(db: DeviceBatch, target_b: int) -> DeviceBatch:
    """Pad a batch to `target_b` epochs (zero gain => silent padding)."""
    return pad_epoch_axis(db, target_b)


def resolve_device(impl: str, device) -> torch.device:
    """The device a run of `impl` uses; raises ValueError or RuntimeError
    if it cannot run there (no silent fallback to the CPU)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = torch.device(device)
    if impl.startswith("cuda") and device.type != "cuda":
        raise ValueError(f"impl '{impl}' runs the CUDA kernel and needs a "
                         f"CUDA device, got '{device}'; impl "
                         f"'{impl.replace('cuda', 'torch')}' runs the plain "
                         f"PyTorch version on any device")
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


def writes_words(impl: str) -> bool:
    """Whether synth_batch_outputs gives `impl`'s batch as the kernel's
    [B, W] int32 packed words (cuda, torch), rather than pieces of packed
    [B, n_out, 2] samples."""
    return impl in ("cuda", "torch")


def synth_batch_outputs(scn: Scenario, seg, e: int, e1: int,
                        batch_epochs: int, impl: str, device, mesh=None,
                        nav_gather: bool = False) -> list:
    """Plan epochs [e, e1) of segment `seg`, padded to `batch_epochs`, and
    enqueue their synthesis in `scn`'s format on the device, without
    waiting. Returns the device outputs: one [B, W] int32 word tensor for
    cuda / torch (writes_words), else the packed samples of each piece:
    one for closed, one per time shard of `mesh` for the sharded impls."""
    n = scn.iq_buff_size
    fmt = scn.config.data_format
    plain = impl.startswith("torch")
    sharded = impl.endswith("-sharded")
    if sharded:
        from gps_sdr_sim_tpu_torch.parallel.shard import (
            synth_batch_sharded,
            synth_epochs_sharded,
        )
    if impl.startswith("closed"):
        db = _pad_batch(plan_batch(seg, e, e1, n, scn.delt), batch_epochs)
        iq = (synth_batch_sharded(db, n, mesh) if sharded
              else [synth_closed.synth_batch(db, n, device)])
        return [pack(p, fmt) for p in iq]
    eb = pad_epochs(plan_epochs(seg, e, e1, scn.delt), batch_epochs)
    if sharded:
        return [pack(p, fmt) for p in synth_epochs_sharded(
            eb, n, mesh, plain, nav_gather)]
    return [synth.synth_staged_packed(synth.stage_epochs(eb, device), n, fmt,
                                      plain, nav_gather)]


def run_epoch_range(scn: Scenario, fp: BinaryIO, lo: int, hi: int,
                    batch_epochs: int = 20,
                    log: Optional[Callable[[str], None]] = None,
                    impl: str = "cuda", device="cuda",
                    mesh=None) -> RunStats:
    """Synthesize output epochs [lo, hi) of `scn` into `fp`.

    impl: "cuda" (the hand-written kernel; needs a CUDA device), "torch"
    (the kernel's plain PyTorch version, on `device`) or "closed" (the
    closed form from a DeviceBatch, plain torch on `device`);
    "cuda-sharded", "torch-sharded" or "closed-sharded" run the same over
    `mesh` (parallel.mesh.Mesh; default auto_mesh over every local device
    of `device`'s type). The kernel's nav mask-table variant runs when
    GPS_SDR_SIM_NAV_GATHER=1 at this call (ops.synth.nav_gather_enabled).
    Raises ValueError for batch_epochs < 1 (iter_segment_batches), before
    anything is written."""
    if log is None:
        log = lambda s: print(s, end="", file=sys.stderr, flush=True)
    device = resolve_device(impl, device)
    words = writes_words(impl)
    if impl.endswith("-sharded"):
        from gps_sdr_sim_tpu_torch.parallel.mesh import auto_mesh

        if mesh is None:
            mesh = auto_mesh(device=device)
        if impl.startswith("cuda") and any(
                d.type != "cuda" for row in mesh.grid for d in row):
            raise ValueError(f"impl '{impl}' runs the CUDA kernel and needs "
                             f"a mesh of CUDA devices")
    n = scn.iq_buff_size
    fmt = scn.config.data_format
    nav_gather = synth.nav_gather_enabled()
    stats = RunStats()
    t_start = time.time()
    # (pieces: [(host array or tensor, copy-done event or None)], valid
    # epochs)
    pending = deque()

    def flush(item):
        pieces, valid = item
        t0 = time.time()
        for _, done in pieces:
            if done is not None:
                done.synchronize()
        t1 = time.time()
        for host, _ in pieces:
            rows = host.numpy()[:valid]
            if len(rows) == 0:
                break
            valid -= len(rows)
            if words:
                rows = words_to_bytes(rows, n, fmt)
            fp.write(np.ascontiguousarray(rows).reshape(-1).view(np.uint8)
                     .data)
        stats.fetch_seconds += t1 - t0
        stats.write_seconds += time.time() - t1

    for seg, e, e1 in iter_seg_batches(scn, lo, hi, batch_epochs):
        t_plan = time.time()
        outs = synth_batch_outputs(scn, seg, e, e1, batch_epochs, impl,
                                   device, mesh, nav_gather)
        pieces = [fetch_async(o) if o.device.type == "cuda" else (o, None)
                  for o in outs]
        stats.plan_seconds += time.time() - t_plan
        if len(pending) >= _QUEUE_DEPTH:
            flush(pending.popleft())
        pending.append((pieces, e1 - e))
        stats.device_batches += 1
        stats.total_samples += (e1 - e) * n
        log(f"\rTime into run = {(seg.first_epoch + e1 - 1) * 0.1:4.1f}")

    while pending:
        flush(pending.popleft())

    stats.wall_seconds = time.time() - t_start
    return stats


def run_simulation(scn: Scenario, fp: BinaryIO, batch_epochs: int = 20,
                   log: Optional[Callable[[str], None]] = None,
                   impl: str = "cuda", device="cuda", mesh=None) -> RunStats:
    """Synthesize the whole scenario into `fp`. Returns throughput stats."""
    return run_epoch_range(scn, fp, 0, scn.n_output_epochs,
                           batch_epochs=batch_epochs, log=log, impl=impl,
                           device=device, mesh=mesh)
