"""Fused I/Q synthesis: the wrapper, its plain PyTorch version, and staging.

Counterpart of gps_sdr_sim_tpu/ops/synth_pallas.py on the single-chip
packed path. One call turns a batch of per-epoch wires (plan.pack_epoch_wire,
[B, C, 12] int32) into the final output words, [B, SB * SUBBLOCK / div]
int32, SB = ceil(n_out / SUBBLOCK): viewed as little-endian bytes, each
epoch's row is the SC16/SC08/SC01 file stream, and its first
packed_bytes(n_out, fmt) bytes are valid.

`synth_wire` is the kernel's wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/synth.cu, via ops/synth_cuda.py) or raises; on a
CPU tensor it runs `synth_wire_ref`. `synth_wire_ref` is the plain version,
on any device. The arithmetic, which both follow exactly, is spelled out at
the top of csrc/synth.cu; `_channel_contribution` in
gps_sdr_sim_tpu/ops/synth_jnp.py is the readable statement of what it
computes.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from gps_sdr_sim_tpu.constants import CA_SEQ_LEN, MAX_CHAN, SUBBLOCK
from gps_sdr_sim_tpu.ops.plan import WIRE_LANES, pack_epoch_wire
from gps_sdr_sim_tpu.ops.tables import COS_TABLE512, SIN_TABLE512

# Samples per int32 output word: SC16 one I/Q pair, SC08 two, SC01 sixteen.
PACK_DIV = {16: 1, 8: 2, 1: 16}

_MASK40 = (1 << 40) - 1

# Launches of the hand-written kernel, counted where the wrapper launches it.
launch_counts = {"synth_wire": 0}


def packed_bytes(n_out: int, fmt: int) -> int:
    """Valid output bytes per epoch of n_out samples in format `fmt`.

    SC01 drops a trailing partial byte like the reference (loop bound
    iq_buff_size/4, gpssim.c:2268)."""
    return {16: n_out * 4, 8: n_out * 2, 1: n_out // 4}[fmt]


def words_per_epoch(n_out: int, fmt: int) -> int:
    return -(-n_out // SUBBLOCK) * SUBBLOCK // PACK_DIV[fmt]


_TABLE_CACHE: dict = {}
_CA_CACHE: dict = {}


def trig_table(device) -> torch.Tensor:
    """[2, 512] int32 sin/cos table (gpssim.c:15-83) on `device`, cached."""
    device = torch.device(device)
    t = _TABLE_CACHE.get(device)
    if t is None:
        t = _TABLE_CACHE[device] = torch.from_numpy(
            np.stack([SIN_TABLE512, COS_TABLE512]).astype(np.int32)).to(device)
    return t


def _ca_device(ca_words: np.ndarray, device) -> torch.Tensor:
    """Per-segment C/A words are identical across a segment's batches:
    upload each table once per device."""
    device = torch.device(device)
    key = (ca_words.tobytes(), device)
    t = _CA_CACHE.get(key)
    if t is None:
        if len(_CA_CACHE) > 64:
            _CA_CACHE.clear()
        t = _CA_CACHE[key] = torch.from_numpy(
            np.ascontiguousarray(ca_words, dtype=np.int32)).to(device)
    return t


class Staged(NamedTuple):
    """One batch of epochs on the device: what the kernel reads."""
    wire: torch.Tensor      # [B, C, 12] int32
    ca_words: torch.Tensor  # [C, 32] int32
    n_chan: int             # active channels, compacted first


def stage_epochs(eb, device) -> Staged:
    """EpochBatch (ops.plan.plan_epochs) -> device tensors.

    The wire is plan.pack_epoch_wire's int32 view of little-endian int64
    phase words (plan._split2), so the host must be little-endian. A CUDA
    upload goes from pinned memory on the current stream without blocking
    the host."""
    if sys.byteorder != "little":
        raise RuntimeError("the epoch wire is a little-endian byte view")
    device = torch.device(device)
    host = torch.from_numpy(pack_epoch_wire(eb))
    if device.type == "cuda":
        host = host.pin_memory()
    wire = host.to(device, non_blocking=True)
    return Staged(wire, _ca_device(eb.ca_words, device), max(eb.n_chan, 1))


# ---------------------------------------------------------------------------
# Plain PyTorch version. All arithmetic is int64 on exact integers; int32
# wrap-around is applied explicitly where the kernel wraps.
# ---------------------------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """floor(a / b): M and the nav bit index are floor divisions, and
    T = -1 is reachable (CUDA's `/` truncates toward zero instead)."""
    return torch.div(a, b, rounding_mode="floor")


def shr_signfill(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x >> s for int32-valued x, sign-filling when s < 0 or s > 31 (the
    XLA rule for out-of-range shift amounts; C++ leaves it undefined)."""
    out_of_range = (s < 0) | (s > 31)
    return torch.where(out_of_range, x >> 31, x >> s.clamp(0, 31))


def rebase(f: torch.Tensor, s: torch.Tensor, k0: torch.Tensor):
    """Exact f + k0 * s for 2^56-scaled f, s >= 0 and k0 < 2^21.

    The 16/40-bit split of plan.py keeps every term below 2^63 where the
    naive product reaches ~2^75 at 1 Msps. Returns (bits [16, 56) of the
    sum in units of 2^-40, bits >= 56 as whole units)."""
    lo = (f & 0xFFFF) + k0 * (s & 0xFFFF)
    hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16)
    return hi & _MASK40, hi >> 40


def _unpack(wire: torch.Tensor) -> dict:
    w = wire.to(torch.int64)

    def u64(lane):
        return (w[..., lane] & 0xFFFFFFFF) | (w[..., lane + 1] << 32)

    m0 = w[..., 9] & 0xFFFF
    b0 = w[..., 9] >> 16
    return dict(code_f=u64(0), code_s=u64(2), carr_f=u64(4), carr_s=u64(6),
                t0=w[..., 8], m0r=m0 - 20 * b0, navbits=w[..., 10],
                gain=w[..., 11])


def _quantized_iq(wire, ca_words, n_chan: int, sub_blocks: int):
    """(I, Q) after (acc + 64) >> 7, int64 [B, SB, SUBBLOCK], before the
    int16 wrap."""
    dev = wire.device
    u = _unpack(wire)
    k0 = (torch.arange(sub_blocks, device=dev, dtype=torch.int64)
          * SUBBLOCK)[None, :]                       # [1, SB]
    r = torch.arange(SUBBLOCK, device=dev, dtype=torch.int64)
    tbl = trig_table(dev).to(torch.int64)
    ca = ca_words.to(torch.int64)
    B = wire.shape[0]
    iacc = torch.zeros((B, sub_blocks, SUBBLOCK), dtype=torch.int64,
                       device=dev)
    qacc = torch.zeros_like(iacc)
    for c in range(n_chan):
        def col(name):
            return u[name][:, c, None]               # [B, 1]

        base, carry = rebase(col("code_f"), col("code_s"), k0)
        step = (col("code_s") >> 16)[..., None]
        T = _wrap32((col("t0") + carry)[..., None]
                    + ((base[..., None] + r * step) >> 40))
        M = floor_div(T, CA_SEQ_LEN)
        chip = T - CA_SEQ_LEN * M
        ca_bit = (ca[c][chip >> 5] >> (chip & 31)) & 1
        j = floor_div(col("m0r")[..., None] + M, 20)
        nav_bit = shr_signfill(col("navbits")[..., None], j) & 1
        cbase, _ = rebase(col("carr_f"), col("carr_s"), k0)
        cstep = (col("carr_s") >> 16)[..., None]
        idx = ((cbase[..., None] + r * cstep) >> 31) & 0x1FF
        sign = 1 - 2 * (ca_bit ^ nav_bit)
        g = col("gain")[..., None] * sign
        iacc += g * tbl[1][idx]
        qacc += g * tbl[0][idx]
    return (_wrap32(_wrap32(iacc) + 64) >> 7,
            _wrap32(_wrap32(qacc) + 64) >> 7)


def synth_wire_ref(wire: torch.Tensor, ca_words: torch.Tensor, n_chan: int,
                   n_out: int, fmt: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same words, any device."""
    B = wire.shape[0]
    sub_blocks = -(-n_out // SUBBLOCK)
    i16, q16 = _quantized_iq(wire, ca_words, n_chan, sub_blocks)
    i16 = i16.reshape(B, -1)
    q16 = q16.reshape(B, -1)
    if fmt == 16:
        words = (i16 & 0xFFFF) | (q16 << 16)
    elif fmt == 8:
        ib = (_wrap16(i16) >> 4) & 0xFF
        qb = (_wrap16(q16) >> 4) & 0xFF
        pair = (ib | (qb << 8)).reshape(B, -1, 2)
        words = pair[..., 0] | (pair[..., 1] << 16)
    elif fmt == 1:
        k = torch.arange(16, device=wire.device, dtype=torch.int64)
        bit = 8 * (k >> 2) + 7 - 2 * (k & 3)
        ib = (_wrap16(i16) > 0).to(torch.int64).reshape(B, -1, 16)
        qb = (_wrap16(q16) > 0).to(torch.int64).reshape(B, -1, 16)
        words = ((ib << bit) | (qb << (bit - 1))).sum(dim=-1)
    else:
        raise ValueError(f"Invalid I/Q data format: {fmt}")
    return _wrap32(words).to(torch.int32)


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------


def _check(wire, ca_words, n_chan: int, n_out: int, fmt: int) -> None:
    if fmt not in PACK_DIV:
        raise ValueError(f"Invalid I/Q data format: {fmt}")
    if wire.dtype != torch.int32 or ca_words.dtype != torch.int32:
        raise TypeError("wire and ca_words must be int32")
    if wire.dim() != 3 or wire.shape[2] != WIRE_LANES:
        raise ValueError(f"wire must be [B, C, {WIRE_LANES}], "
                         f"got {tuple(wire.shape)}")
    if not 1 <= wire.shape[0] <= 65535:
        raise ValueError(f"epoch count {wire.shape[0]} outside [1, 65535]")
    C = wire.shape[1]
    if tuple(ca_words.shape) != (C, 32):
        raise ValueError(f"ca_words must be [{C}, 32], "
                         f"got {tuple(ca_words.shape)}")
    if not 1 <= n_chan <= min(C, MAX_CHAN):
        raise ValueError(f"n_chan {n_chan} outside [1, {min(C, MAX_CHAN)}]")
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if wire.device != ca_words.device:
        raise ValueError("wire and ca_words are on different devices")
    if not (wire.is_contiguous() and ca_words.is_contiguous()):
        raise ValueError("wire and ca_words must be contiguous")


def synth_wire(wire: torch.Tensor, ca_words: torch.Tensor, n_chan: int,
               n_out: int, fmt: int) -> torch.Tensor:
    """[B, C, 12] wire -> [B, words_per_epoch(n_out, fmt)] int32 words.

    CUDA tensors go through the hand-written kernel (a build or launch
    failure raises); CPU tensors through synth_wire_ref."""
    _check(wire, ca_words, n_chan, n_out, fmt)
    if wire.device.type == "cpu":
        return synth_wire_ref(wire, ca_words, n_chan, n_out, fmt)
    if wire.device.type != "cuda":
        raise ValueError(f"no kernel for device {wire.device}")
    from gps_sdr_sim_tpu_torch.ops import synth_cuda

    out = torch.empty((wire.shape[0], words_per_epoch(n_out, fmt)),
                      dtype=torch.int32, device=wire.device)
    synth_cuda.launch(wire, ca_words, trig_table(wire.device), out, n_chan,
                      -(-n_out // SUBBLOCK), fmt)
    launch_counts["synth_wire"] += 1
    return out


def synth_staged_packed(staged: Staged, n_out: int, fmt: int = 16,
                        plain: bool = False) -> torch.Tensor:
    """Staged batch -> [B, words] int32 output words (see module doc);
    plain=True runs synth_wire_ref on the staged device instead."""
    fn = synth_wire_ref if plain else synth_wire
    return fn(staged.wire, staged.ca_words, staged.n_chan, n_out, fmt)
