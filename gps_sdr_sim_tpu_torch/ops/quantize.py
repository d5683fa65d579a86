"""Packed output words -> file bytes, and their checksum.

Counterpart of the packed-word helpers of gps_sdr_sim_tpu/ops/quantize.py.
The kernel epilogue already writes the final SC16/SC08/SC01 stream
(ops/synth.py), so nothing here re-packs samples.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_sim_tpu_torch.ops.synth import packed_bytes

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
