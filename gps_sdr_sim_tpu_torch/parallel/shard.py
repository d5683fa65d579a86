"""IQ synthesis sharded over a ('time', 'chan') mesh of devices.

Counterpart of gps_sdr_sim_tpu/parallel/shard.py. Layout:
  epochs   (B axis) -> 'time' : embarrassingly parallel, nothing exchanged;
  channels (C axis) -> 'chan' : each device sums its channel slice, and the
                                raw int32 partial sums are added on the time
                                shard's first device *before* the
                                (acc + 64) >> 7 quantization, as the reference
                                sums all channels first (gpssim.c:2192-2259).

Three inputs, three functions:
  * synth_epochs_sharded: the compact [B, C, 12] wire (plan.pack_epoch_wire),
    rebased on each device by the kernel (the runner's cuda-sharded and
    torch-sharded impls);
  * synth_rows_sharded: a DeviceBatch (plan.plan_batch) as the row kernel's
    [B, SB, C, 12] rows (the counterpart of synth_pallas_sharded);
  * synth_batch_sharded: a DeviceBatch through the closed form in plain
    torch (ops/synth_closed.py; impl closed-sharded, the counterpart of
    xla-sharded).
A kernel launches its planes mode on a time-only mesh (int16 I/Q after the
quantization) and its raw mode on every chan shard otherwise.
Each launch runs on its device's current stream; the copy of a partial sum
to another card is a plain torch copy, which orders itself against both
devices' current streams.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gps_sdr_sim_tpu_torch import spans
from gps_sdr_sim_tpu_torch.ops import synth, synth_closed
from gps_sdr_sim_tpu_torch.ops.plan import (
    DeviceBatch,
    pack_epoch_wire,
    pad_epoch_axis,
)
from gps_sdr_sim_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS, Mesh


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
    (impl 'torch-sharded'; the counterpart of impl 'xla-sharded' is
    synth_batch_sharded)."""
    n_time = mesh.shape[TIME_AXIS]
    n_chan_dev = mesh.shape[CHAN_AXIS]
    with spans.span("plan.pack_epoch_wire"):
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
            with spans.span("synth.upload"):
                w = synth.upload_wire(
                    wire[e0:e0 + b_loc, c * c_loc:(c + 1) * c_loc], dev)
                k = synth.ca_device(ca[c * c_loc:(c + 1) * c_loc], dev)
            with spans.span("synth.launch"):
                outs.append(kernel(w, k, c_loc, n_out, nav_gather))
        launched.append((row[0], min(b_loc, B - e0), outs))

    return _pieces(launched, n_out, reduce=n_chan_dev > 1)


def _pad_time(db: DeviceBatch, mult: int) -> tuple[DeviceBatch, int]:
    """Pad the epoch axis to a multiple of the mesh 'time' size: the last
    epoch's ramps repeated with gain 0, so padded epochs synthesize silence.
    Returns (padded batch, epochs before padding)."""
    b = db.gain.shape[0]
    return pad_epoch_axis(db, -(-b // mult) * mult), b


def _block(db: DeviceBatch, e0: int, e1: int, c0: int,
           c1: int) -> DeviceBatch:
    """Epochs [e0, e1) and channels [c0, c1) of a DeviceBatch."""
    def cut(name, a):
        if name == "ca_words":
            return a[c0:c1]
        if name in ("code_p", "carr_p", "t_base"):  # [B, SB, C, ...]
            return a[e0:e1, :, c0:c1]
        return a[e0:e1, c0:c1]                      # [B, C, ...]

    return DeviceBatch(**{f.name: cut(f.name, getattr(db, f.name))
                          for f in dataclasses.fields(db)})


def _shards(db: DeviceBatch, mesh: Mesh):
    """Yield (time shard's first device, valid epochs, [(device, block)] per
    chan shard) for every time shard that holds a valid epoch, after
    padding the epochs to a multiple of the time axis. Raises ValueError
    when the chan axis does not divide the channels."""
    n_time = mesh.shape[TIME_AXIS]
    n_chan_dev = mesh.shape[CHAN_AXIS]
    C = db.gain.shape[1]
    if C % n_chan_dev != 0:
        raise ValueError(f"{C} channels not divisible by mesh "
                         f"'chan' size {n_chan_dev}")
    db, B = _pad_time(db, n_time)
    b_loc = db.gain.shape[0] // n_time
    c_loc = C // n_chan_dev
    for t, row in enumerate(mesh.grid):
        e0 = t * b_loc
        if e0 >= B:
            break
        yield row[0], min(b_loc, B - e0), [
            (dev, _block(db, e0, e0 + b_loc, c * c_loc, (c + 1) * c_loc))
            for c, dev in enumerate(row)]


def _pieces(launched: list, n_out: int, reduce: bool) -> list:
    """[(time shard's first device, valid epochs, [(I, Q) per chan
    shard])] -> the [valid, n_out, 2] int16 piece of each time shard.
    reduce: the (I, Q) are raw int32 sums [b, SB * SUBBLOCK], added by
    _reduce_chan; else there is one chan shard and its planes are int16."""
    pieces = []
    for dev0, valid, outs in launched:
        with spans.span("shard.stack"):
            if reduce:
                i16 = _reduce_chan([o[0] for o in outs], dev0)
                q16 = _reduce_chan([o[1] for o in outs], dev0)
            else:
                ((i16, q16),) = outs
            pieces.append(torch.stack([i16[:valid, :n_out],
                                       q16[:valid, :n_out]], dim=-1))
    return pieces


def synth_batch_sharded(db: DeviceBatch, n_out: int, mesh: Mesh) -> list:
    """DeviceBatch -> the [B, n_out, 2] int16 samples of the closed form
    (ops/synth_closed.py), sharded over `mesh`: the counterpart of
    gps_sdr_sim_tpu/parallel/shard.py:synth_batch_sharded.

    Every mesh entry accumulates its block's raw int32 sums in plain torch
    on its device; the chan shards' sums are added mod 2^32 on the time
    shard's first device before (acc + 64) >> 7. Returns one piece per
    time shard, as synth_epochs_sharded does; epoch padding is silent and
    stripped, and a time shard of padding only is not run. Raises
    ValueError when the chan axis does not divide the channels."""
    launched = []
    for dev0, valid, blocks in _shards(db, mesh):
        parts = []
        for dev, blk in blocks:
            with spans.span("synth.upload"):
                args = synth_closed.batch_tensors(blk, dev)
            with spans.span("synth.launch"):
                acc = synth_closed.accumulate(*args)
                parts.append(tuple(a.reshape(a.shape[0], -1) for a in acc))
        launched.append((dev0, valid, parts))
    return _pieces(launched, n_out, reduce=True)


def synth_rows_sharded(db: DeviceBatch, n_out: int, mesh: Mesh) -> list:
    """DeviceBatch -> the [B, n_out, 2] int16 samples of the row kernel,
    sharded over `mesh`: the counterpart of
    gps_sdr_sim_tpu/parallel/shard.py:synth_pallas_sharded.

    Each mesh entry's rows (ops.synth.pack_rows of its block) go up pinned
    and without blocking the host. A time-only mesh launches the planes
    mode; a chan axis above 1 launches the raw mode on every entry and adds
    the chan shards' sums mod 2^32 before (acc + 64) >> 7. Returns one piece
    per time shard, like synth_batch_sharded."""
    n_chan_dev = mesh.shape[CHAN_AXIS]
    kernel = synth.synth_rows_planes if n_chan_dev == 1 else \
        synth.synth_rows_raw
    launched = []
    for dev0, valid, blocks in _shards(db, mesh):
        outs = [kernel(synth.upload_rows(synth.pack_rows(blk), dev),
                       synth.ca_device(blk.ca_words, dev))
                for dev, blk in blocks]
        launched.append((dev0, valid, outs))
    return _pieces(launched, n_out, reduce=n_chan_dev > 1)
