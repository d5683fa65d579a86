"""The yardstick's card and work arithmetic: the published peaks of one
NVIDIA H100 SXM and the operations and bytes that synthesizing an epoch
needs, whatever kernels do it.

A copy of the port's tools/card.py arithmetic (ALGORITHM_OPS, ISSUE_PER_S,
HBM_BYTES_PER_S), kept here so that a change to the port cannot move the
yardstick.
"""

from __future__ import annotations

import subprocess

import numpy as np

# NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 bytes per
# second, and one 32-bit integer instruction per lane per clock on every
# scheduler, i.e. the 67 TFLOP/s float32 rate counted in FMAs.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2

# The integer operations the synthesis algorithm needs per (sample, channel
# whose gain is not 0): advance the code phase, whole chip, its wrap into
# the 1023-chip period, C/A bit, nav bit, sign, advance the carrier phase,
# table index, cos and sin lookups, two gain products, two signed sums.
OPS_PER_SAMPLE_CHANNEL = 14
# Per quantized output sample: the rounding and packing.
OPS_PER_QUANTIZED_SAMPLE = 4
# What the kernel reads per (epoch, channel): the 12 int32 words of the
# port's wire, the same as the 10 planned fields' 48 bytes.
WIRE_BYTES_PER_CHANNEL = 48
# Per epoch and channel, the channel's 1023 C/A chips as 32 int32 words.
CA_BYTES_PER_CHANNEL = 32 * 4


def output_bytes(n_out: int, fmt: int) -> int:
    """Bytes of one epoch of n_out samples in SC16, SC08 or SC01 (a
    trailing partial SC01 byte dropped, as the upstream program does)."""
    return {16: n_out * 4, 8: n_out * 2, 1: n_out // 4}[fmt]


def epoch_least_seconds(gain_channels: np.ndarray, n_out: int,
                        fmt: int) -> np.ndarray:
    """The least time the card could take to synthesize each epoch, given
    its number of channels with gain: the larger of its operations over
    ISSUE_PER_S and its bytes (each input read once, each output written
    once) over HBM_BYTES_PER_S."""
    g = np.asarray(gain_channels, dtype=np.float64)
    ops = (OPS_PER_SAMPLE_CHANNEL * g * n_out
           + OPS_PER_QUANTIZED_SAMPLE * n_out)
    moved = (g * (WIRE_BYTES_PER_CHANNEL + CA_BYTES_PER_CHANNEL)
             + output_bytes(n_out, fmt))
    return np.maximum(ops / ISSUE_PER_S, moved / HBM_BYTES_PER_S)


def card_line(index: int = 0) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of card `index`, or "" if
    nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[index] if index < len(lines) else ""
