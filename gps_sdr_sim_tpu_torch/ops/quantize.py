"""Output sample-format packing, packed output words -> file bytes, and
their checksum.

Counterpart of gps_sdr_sim_tpu/ops/quantize.py. On the single-device path
the kernel epilogue already writes the final SC16/SC08/SC01 stream
(ops/synth.py) and only words_to_bytes is needed; the sharded path
(parallel/shard.py) returns [B, N, 2] int16 samples, which pack() turns
into the format's bytes on their device (gpssim.c:2266-2288):
 - SC16: int16 I/Q pairs as they are;
 - SC08: arithmetic >> 4 of each int16 sample, wrapped to int8;
 - SC01: the sign bit (sample > 0) of each interleaved I/Q value packed
   MSB-first, 4 IQ pairs per byte: {I0,Q0,I1,Q1,I2,Q2,I3,Q3}.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.ops.synth import packed_bytes

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_sc16(iq: torch.Tensor) -> torch.Tensor:
    """[B, N, 2] int16 -> int16 interleaved I/Q (layout already correct)."""
    return iq


def pack_sc08(iq: torch.Tensor) -> torch.Tensor:
    """[B, N, 2] int16 -> int8 via arithmetic >> 4 (the low byte kept, as
    JAX's astype(int8) keeps it)."""
    return ((iq >> 4) & 0xFF).to(torch.uint8).view(torch.int8)


def pack_sc01(iq: torch.Tensor) -> torch.Tensor:
    """[B, N, 2] int16 -> [B, N//4] uint8, sign bits packed MSB-first.

    Like the reference (gpssim.c:2266-2276, loop bound iq_buff_size/4),
    a trailing partial group of <4 IQ pairs is dropped."""
    b, n, _ = iq.shape
    n4 = n // 4
    bits = (iq[:, :n4 * 4] > 0).reshape(b, n4, 8).to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=iq.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def pack(iq: torch.Tensor, data_format: int) -> torch.Tensor:
    if data_format == 16:
        return pack_sc16(iq)
    if data_format == 8:
        return pack_sc08(iq)
    if data_format == 1:
        return pack_sc01(iq)
    raise ValueError(f"Invalid I/Q data format: {data_format}")


# Element type each format's checksum reads: SC16 int16 samples, SC08 int8
# samples, SC01 the packed bytes.
_CHECKSUM_DTYPE = {16: torch.int16, 8: torch.int8, 1: torch.uint8}


def words_to_bytes(words: np.ndarray, n_out: int, fmt: int) -> np.ndarray:
    """Host [B, W] int32 words -> [B, valid_bytes] uint8 view (zero-copy
    until the caller materializes it)."""
    b = words.shape[0]
    return words.view(np.uint8).reshape(b, -1)[:, :packed_bytes(n_out, fmt)]


def checksum_packed(words: torch.Tensor, valid_epochs: int, n_out: int,
                    fmt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, nonzero_count) over the VALID region of a packed word batch,
    both int64 on the words' device.

    The typed view follows the bench golden (tests/golden/
    bench_checksum.txt): SC16 sums int16 samples, SC08 int8 samples, SC01
    the packed uint8 bytes; nonzero counts nonzero elements of that view.
    The golden sums are int32-wrapped totals; see wrap_int32. This is the
    counterpart of the JAX package's checksum_packed, kept for parity with
    it and held to it by the tests; what the runner writes is checksummed
    with checksum_bytes."""
    w = words[:valid_epochs]
    v = w.view(_CHECKSUM_DTYPE[fmt]).reshape(w.shape[0], -1)
    v = v[:, :packed_bytes(n_out, fmt) // v.element_size()]
    return v.sum(dtype=torch.int64), torch.count_nonzero(v)


def checksum_bytes(data, fmt: int) -> tuple[int, int]:
    """checksum_packed over a writable, non-empty host buffer of valid
    epochs (what the runner writes), as exact Python ints."""
    v = torch.frombuffer(data, dtype=_CHECKSUM_DTYPE[fmt])
    return int(v.sum(dtype=torch.int64)), int(torch.count_nonzero(v))


def wrap_int32(x: int) -> int:
    """x mod 2^32 read as a signed int32: the bench golden's sums were
    accumulated in int32 (bench.py asks for int64 with x64 disabled)."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)
