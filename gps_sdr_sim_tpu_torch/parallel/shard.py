"""IQ synthesis sharded over a ('time', 'chan') mesh of devices.

Counterpart of synth_epochs_sharded in gps_sdr_sim_tpu/parallel/shard.py
(the compact-wire path). Layout of the [B, C, 12] wire (plan.pack_epoch_wire):
  epochs   (B axis) -> 'time' : embarrassingly parallel, nothing exchanged;
  channels (C axis) -> 'chan' : each device sums its channel slice, and the
                                raw int32 partial sums are added on the time
                                shard's first device *before* the
                                (acc + 64) >> 7 quantization, as the reference
                                sums all channels first (gpssim.c:2192-2259).

A time-only mesh launches the planes mode of the kernel (int16 I/Q after
the quantization); a chan axis above 1 launches the raw mode on every chan
shard; nav_gather=True runs either's nav-gather variant.
Each launch runs on its device's current stream; the copy of a partial sum
to another card is a plain torch copy, which orders itself against both
devices' current streams.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.plan import pack_epoch_wire
from gps_sdr_sim_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS, Mesh


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without blocking the host (from pinned
    memory for a card)."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _reduce_chan(parts: list, device: torch.device) -> torch.Tensor:
    """Raw int32 partial sums of one plane, one per chan shard -> int16
    samples on `device`: the sum mod 2^32 (psum's int32 wrap), then
    (acc + 64) >> 7 and the int16 wrap."""
    acc = parts[0].to(torch.int64)
    for p in parts[1:]:
        acc += p.to(device, non_blocking=True).to(torch.int64)
    return synth.quantize_int16(acc)


def synth_epochs_sharded(eb, n_out: int, mesh: Mesh, plain: bool = False,
                         nav_gather: bool = False) -> list:
    """EpochBatch -> the [B, n_out, 2] int16 samples, sharded over `mesh`.

    Returns one piece per time shard, in epoch order, each on its time
    shard's first device (grid[t][0]); concatenated they are the
    [B, n_out, 2] result. Epoch padding (to a multiple of the time axis)
    and channel padding (to a multiple of the chan axis) are zero-gain rows
    that synthesize silence; epoch padding is stripped, and a time shard
    that holds only padding is not launched. Every chan shard sums all of
    its local channels, as the JAX package's kernel does.

    plain=True runs the kernel modes' plain versions on the same devices
    (the counterpart of impl 'xla-sharded', here on the wire too)."""
    n_time = mesh.shape[TIME_AXIS]
    n_chan_dev = mesh.shape[CHAN_AXIS]
    wire = pack_epoch_wire(eb)
    B, C, _ = wire.shape
    b_loc = -(-B // n_time)
    c_loc = -(-max(C, 1) // n_chan_dev)
    wire = np.pad(wire, ((0, b_loc * n_time - B),
                         (0, c_loc * n_chan_dev - C), (0, 0)))
    ca = np.pad(eb.ca_words, ((0, c_loc * n_chan_dev - C), (0, 0)))
    if n_chan_dev == 1:
        kernel = synth.synth_wire_planes_ref if plain \
            else synth.synth_wire_planes
    else:
        kernel = synth.synth_wire_raw_ref if plain else synth.synth_wire_raw

    # Enqueue every entry's upload and launch before any reduction, so the
    # devices of the mesh run side by side.
    launched = []
    for t, row in enumerate(mesh.grid):
        e0 = t * b_loc
        if e0 >= B:
            break
        outs = []
        for c, dev in enumerate(row):
            w = _upload(wire[e0:e0 + b_loc, c * c_loc:(c + 1) * c_loc], dev)
            k = synth.ca_device(ca[c * c_loc:(c + 1) * c_loc], dev)
            outs.append(kernel(w, k, c_loc, n_out, nav_gather))
        launched.append((row[0], min(b_loc, B - e0), outs))

    pieces = []
    for dev0, valid, outs in launched:
        if n_chan_dev == 1:
            i16, q16 = outs[0]
        else:
            i16 = _reduce_chan([o[0] for o in outs], dev0)
            q16 = _reduce_chan([o[1] for o in outs], dev0)
        pieces.append(torch.stack([i16[:valid, :n_out], q16[:valid, :n_out]],
                                  dim=-1))
    return pieces
