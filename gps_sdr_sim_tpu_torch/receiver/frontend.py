"""IQ file front end: read every gpssim.bin format back to complex baseband.

Inverts the three writers of ops/quantize.py (reference formats:
SC16 gpssim.c:2285-2288, SC08 :2278-2284, SC01 packing :2266-2277).
"""

from __future__ import annotations

import numpy as np


def load_iq(source, data_format: int = 16, count: int = -1) -> np.ndarray:
    """Read interleaved I/Q into complex64.

    source: path or bytes; count: number of IQ sample pairs (-1 = all).
    1-bit samples map to ±1, 8/16-bit keep their integer amplitudes.
    """
    if isinstance(source, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(source, dtype=np.uint8)
    else:
        raw = np.fromfile(source, dtype=np.uint8)

    if data_format == 16:
        iq = raw.view(np.int16)
        if count >= 0:
            iq = iq[:2 * count]
        iq = iq.reshape(-1, 2).astype(np.float32)
    elif data_format == 8:
        iq = raw.view(np.int8)
        if count >= 0:
            iq = iq[:2 * count]
        iq = iq.reshape(-1, 2).astype(np.float32)
    elif data_format == 1:
        # 4 IQ pairs per byte, MSB first: {I0,Q0,I1,Q1,I2,Q2,I3,Q3}.
        bits = np.unpackbits(raw)  # MSB first
        iq = (bits.astype(np.float32) * 2.0 - 1.0).reshape(-1, 2)
        if count >= 0:
            iq = iq[:count]
    else:
        raise ValueError(f"Invalid I/Q data format: {data_format}")

    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
